"""Audio file dispatch on the host: which codec reads or writes a file.

The choice is flan_tpu/audio/audio.py:76-157's: a file is read by the
codec its first bytes name, and written by the codec its extension names,
WAV float32 otherwise. Both functions stay in numpy, so a caller can
decode on any thread and decide itself how the samples reach a device
(Audio.load_from_file, io/loader.py).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from flan_tpu_torch.core.audio_buffer import SndfileStrings


def _is_mpeg_frame_sync(head: bytes) -> bool:
    return (len(head) >= 2 and head[0] == 0xFF and (head[1] & 0xE0) == 0xE0
            and (head[1] >> 1) & 0x3 != 0)


def read_audio_file(filename: str
                    ) -> Tuple[np.ndarray, float, SndfileStrings]:
    """File -> (float32 [channels, frames], sample_rate, strings); only
    WAV carries strings, every other codec gives empty ones."""
    with open(filename, "rb") as f:
        head = f.read(12)
    magic = head[:4]
    if magic == b"fLaC":
        from flan_tpu_torch.io.flac import read_flac as read
    elif magic == b"FORM" and head[8:12] in (b"AIFF", b"AIFC"):
        from flan_tpu_torch.io.aiff import read_aiff as read
    elif magic == b"OggS":
        from flan_tpu_torch.io.ogg import read_ogg as read
    elif magic == b".snd":
        from flan_tpu_torch.io.au import read_au as read
    elif magic == b"caff":
        from flan_tpu_torch.io.caf import read_caf as read
    elif magic == b"riff":               # Wave64's lowercase riff GUID
        from flan_tpu_torch.io.w64 import read_w64 as read
    elif magic[:3] == b"ID3" or _is_mpeg_frame_sync(head):
        from flan_tpu_torch.io.mp3 import read_mp3 as read
    else:
        from flan_tpu_torch.io.wav import read_wav
        return read_wav(filename)
    data, sr = read(filename)
    return data, sr, SndfileStrings()


def write_audio_file(filename: str, data: np.ndarray, sample_rate: float,
                     strings: Optional[SndfileStrings] = None) -> None:
    """float32 [channels, frames] -> the codec of filename's extension."""
    low = filename.lower()
    if low.endswith((".au", ".snd")):
        from flan_tpu_torch.io.au import write_au as write
    elif low.endswith(".caf"):
        from flan_tpu_torch.io.caf import write_caf as write
    elif low.endswith(".w64"):
        from flan_tpu_torch.io.w64 import write_w64 as write
    elif low.endswith(".mp3"):
        from flan_tpu_torch.io.mp3 import write_mp3 as write
    elif low.endswith(".flac"):
        from flan_tpu_torch.io.flac import write_flac as write
    elif low.endswith((".aiff", ".aif", ".aifc")):
        from flan_tpu_torch.io.aiff import write_aiff as write
    elif low.endswith((".ogg", ".oga")):
        from flan_tpu_torch.io.ogg import write_ogg as write
    else:
        from flan_tpu_torch.io.wav import write_wav
        write_wav(filename, data, sample_rate, strings)
        return
    write(filename, data, sample_rate)
