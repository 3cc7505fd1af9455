"""Run chip_smoke.py's bf16 and bf16_wide phases alone on the card and
write their kernel records as JSON lines.

    PYTHONPATH=<tree>/src python3 tools/bf16_phases.py OUT.jsonl   (from <tree>)

It imports ``chip_smoke`` from the working directory, so run from the
root of a source tree (a change, or its parent unpacked with ``git
archive``) to time that tree's bf16 kernels; two trees compare only within
one call on one card. Before the phases it runs what they need from the
f32 phases: the tall matrix's f32 FT sweep with ``KILLS`` (the bf16 kill
ledger must equal it) and, at ``WIDE_B``, with ``WIDE_KILLS``. Prints each
record's times, errors and product engine. Needs CUDA; imports no JAX.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path[:0] = [os.path.join(os.getcwd(), "src"), os.getcwd()]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core import SimComm  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

KEYS = ("name", "ms", "device_ms", "f32_ms", "library_ms", "stepped_ms",
        "bound_ms", "float64_scaled_err", "witness_float64_scaled_err",
        "emulation_ulp_ok", "engine")


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    t0 = time.time()
    build.build_all()
    print("build", round(time.time() - t0, 1),
          json.dumps({k: round(v, 1) for k, v in build.SECONDS.items()}), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    A = cs.block_row_layout(rng.standard_normal((cs.P * cs.M_LOC, cs.N))
                            .astype(np.float32), cs.P)
    res = cs.caqr_factorize(A, SimComm(cs.P), cs.B, use_scan=False,
                            collect_bundles=True)
    kill = cs.kill_check(A, SimComm(cs.P), cs.KILLS, cs.flat_result(res))
    del res
    recs = cs.bf16_phase(A, {"kills": kill["ledger"]})
    res = cs.caqr_factorize(A, SimComm(cs.P), cs.WIDE_B, use_scan=False,
                            collect_bundles=True)
    kill = cs.kill_check(A, SimComm(cs.P), cs.WIDE_KILLS, cs.flat_result(res),
                         b=cs.WIDE_B)
    del res
    cs.WIDE_LEDGER["kills"] = kill["ledger"]
    recs += cs.bf16_wide_phase(A)
    with open(sys.argv[1], "w") as f:
        for r in recs:
            f.write(json.dumps(r, default=str) + "\n")
    for r in recs:
        late = r.get("late_panel")
        print({k: r.get(k) for k in KEYS},
              {k: late.get(k) for k in KEYS[1:]} if late else "", flush=True)
    print("seconds", round(time.time() - t0, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
