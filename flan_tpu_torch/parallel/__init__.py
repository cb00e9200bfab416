"""Batch and sequence parallelism over ranks on torch.distributed
(counterpart of flan_tpu/parallel/): mesh.py (the mesh, its collectives
and spawn_ranks), batch.py (clips over ranks), scan_sp.py (recurrences),
conv_sp.py (FFT convolution) and stft_sp.py (the phase vocoder and the
streamed pipelines), each with the time axis sharded."""
