"""Readings for the limits of ``correct``: one cell run on many seeds in
one process (the set-up's builds paid once), each with a short window,
printing every number of the program as served and of the variants asked
for beside it.

    python3 perfbench/readings.py --workload <cell> --seeds 1 2 3 \
        [--variants control ...] [--seconds 3]

The benchmark's own runs do not run this.  Variants (the loops' modules
say what each is): ``control``, the precision below the configuration's;
for inference ``int8``, the program's own int8 path in its place; for
training the fault ``half_batch`` and the looks ``bf16``, ``bf16_grad``
and ``bf16_affine``, and ``cudnn_wgrad``, the program with
its weight-gradient kernel off in its place.  One JSON line per seed: the
program's numbers ("checks") and each variant's ("variants").
"""

import time

T0_NS = time.time_ns()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.harness import env  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variants", nargs="*", default=[],
                   help="readings beside the program's")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    env.prepare()
    import torch
    from perfbench.harness import manifest, runner
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload)
    for seed in args.seeds:
        t = time.time()
        out = runner.run_cell(cell, seed, args.seconds, False, "cuda",
                              time.time_ns(), variants=args.variants,
                              all_checks=True)
        print(json.dumps({"cell": args.workload, "seed": seed,
                          "seconds": time.time() - t,
                          "checks": out["checks"],
                          "variants": out.get("variants", {}),
                          "metrics": out["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
