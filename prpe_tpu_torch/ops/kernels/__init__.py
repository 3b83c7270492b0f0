"""Hand-written CUDA kernels of the serving path, each beside its plain
PyTorch version. Importing these modules builds nothing: a source is
compiled at its first launch, or by ``build_all`` (``_build.py``).

A kernel is three things: its source ``csrc/<name>.cu``, its wrapper module
here, and their tests. The wrapper declares the source once, at import, as
an ``_build.Library``: its ``extern "C"`` entry points with their ctypes
argument types, the launch routes it counts in ``launches`` and any nvcc
flags of its own. It launches through ``Library.launch``, and it is
imported below, so that ``launches`` holds every route from the first
import of this package on. Nothing else lists kernels: ``build_all``, the
build's tests and the traced call's counters (one ``<route>_launches`` a
route, ``utils/profiling.py``) read the declarations.
"""

from prpe_tpu_torch.ops.kernels._build import build_all, launches, reset_launches  # noqa: F401
from prpe_tpu_torch.ops.kernels import attention, bn_act, ln_mhsa, ms_deform_attn, nms  # noqa: F401
