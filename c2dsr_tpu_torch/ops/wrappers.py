"""The kernel wrappers of the train and ranking paths, in one list.

Each wrapper launches one hand-written kernel on a CUDA tensor and counts
its launches (``launches``, and ``launches_bf16`` for its bf16
instantiations).  ``bench/gates.plain_versions`` swaps every one of them
for its plain version; ``capture.py`` captures only while every one is in
place (:func:`kernels_routed`), and adds a graph's launches to these
counters at each replay.  Both read this list, so a wrapper added here is
swapped and counted by both, and one missing a plain version fails the
swap.
"""

from __future__ import annotations

from typing import Any, List, Tuple

from c2dsr_tpu_torch.ops import encoder_cuda, fused_ce_cuda, segsum_cuda
from c2dsr_tpu_torch.ops import spmm_cuda

# (module, attribute) of each wrapper
WRAPPERS = ((spmm_cuda, "spmm_csr"), (spmm_cuda, "spmm_csr_flagged"),
            (encoder_cuda, "encoder_fwd"), (encoder_cuda, "encoder_bwd"),
            (fused_ce_cuda, "ce_fwd"), (fused_ce_cuda, "ce_bwd"),
            (segsum_cuda, "segsum"))
_KERNELS = tuple(getattr(mod, name) for mod, name in WRAPPERS)
_COUNTERS = [(f, a) for f in _KERNELS for a in ("launches", "launches_bf16")
             if hasattr(f, a)]


def launch_counters() -> List[Tuple[Any, str]]:
    """(wrapper, attribute) of every launch counter of the wrappers."""
    return _COUNTERS


def kernels_routed() -> bool:
    """Whether every wrapper is in place: not while
    ``bench/gates.plain_versions`` or a recorder stands in for one."""
    return all(getattr(mod, name) is f
               for (mod, name), f in zip(WRAPPERS, _KERNELS))
