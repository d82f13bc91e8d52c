"""A copy of ``c2dsr_tpu_torch`` whose towers take the tensor-core attention
at every L: ``csrc/encoder_common.cuh``'s kSeqL set to 0, so that K2 and K3
run ``encoder_fwd_attn_kernel`` and ``attn_bwd_dq_kernel`` /
``attn_bwd_dkv_kernel`` (one sequence's 64-row tile a block) where the
checkout runs the whole-sequence kernels (L <= 64).  ``chip_smoke.py
--compare`` against it times both routes in turns at FK (L 15) and at L 64
(its ``step`` and ``l64`` towers), on a card:

    python tests/attn_route_variant.py build/attn_tc_route
    python3 chip_smoke.py --compare build/attn_tc_route

Raises where the substitution no longer finds its text.
"""

from __future__ import annotations

import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE = "constexpr int kSeqL = 64;"


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    dst = os.path.join(os.path.abspath(sys.argv[1]), "c2dsr_tpu_torch")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "c2dsr_tpu_torch"), dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(dst, "csrc", "encoder_common.cuh")
    with open(path) as f:
        text = f.read()
    if text.count(LINE) != 1:
        raise RuntimeError(f"{LINE!r} not found once in {path}")
    with open(path, "w") as f:
        f.write(text.replace(LINE, "constexpr int kSeqL = 0;"))
    print(dst)
    return 0


if __name__ == "__main__":
    sys.exit(main())
