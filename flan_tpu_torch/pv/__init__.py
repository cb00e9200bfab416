"""Phase-vocoder algorithm surface: binds the method groups onto PV, as
flan_tpu/pv/__init__.py does: the algorithms (pv/algorithms.py), the
melody machinery (pv/information.py: get_salience, get_contours, prism,
and the Salience and Contour records) and the modify extras
(pv/modify_extra.py: desample, smear_time, time_extrapolate,
stretch_spline, modify) and the graph conversions
(graph/conversions.py: convert_to_graph, save_to_bmp)."""
from flan_tpu_torch.pv import algorithms as _algorithms
from flan_tpu_torch.pv import information as _information
from flan_tpu_torch.pv import modify_extra as _modify_extra
from flan_tpu_torch.graph import conversions as _graphing
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
_bind(_information, ["get_salience", "get_contours", "prism"])
PV.Salience = _information.Salience
PV.Contour = _information.Contour
_bind(_modify_extra, [
    "desample", "smear_time", "time_extrapolate", "stretch_spline",
    "modify",
])
PV.convert_to_graph = _graphing.pv_convert_to_graph
PV.save_to_bmp = _graphing.pv_save_to_bmp

__all__ = ["PV"]
