"""Phase-vocoder algorithm surface: binds the algorithm group onto PV, as
flan_tpu/pv/__init__.py does. The information group, the modify extras and
the graph conversions are not ported yet."""
from flan_tpu_torch.pv import algorithms as _algorithms
from flan_tpu_torch.pv.pv import PV


def _bind(module, names):
    for name in names:
        setattr(PV, name, getattr(module, name))


_bind(_algorithms, [
    "select", "freeze", "replace_amplitudes", "subtract_amplitudes",
    "add_octaves", "add_harmonics", "shape", "retain_n_loudest_partials",
    "remove_n_loudest_partials", "resonate", "perturb",
])
PV.get_bin_interpolated = _algorithms.get_bin_interpolated
PV.getBinInterpolated = _algorithms.get_bin_interpolated
PV.synthesize = staticmethod(_algorithms.synthesize)

__all__ = ["PV"]
