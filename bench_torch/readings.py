"""Readings that the limits of the comparison were set from, for one cell,
on the card, in one process:

    python3 bench_torch/readings.py --workload <cell> --seeds <n> [<n> ...] --seconds <s>

For each seed: the cell's set-up, a window of ``--seconds`` seconds at the
cell's own load, then the numbers of harness/compare.py for the program's
last step against the float32 reference, and for the control (the
reference in bfloat16, stepping the same state) against the float32
reference. Each is printed at several tolerances, one JSON line a seed.
The reference is the one the configuration's transfer names
(references/<name>.py). With ``--fault <name>`` the program runs with that
fault of harness/faults.py planted where faults/<name>.py of the same name
says, and the control is not run. The benchmark's own
runs never run the control or a fault; their tests at a small size are
bench_torch/tests/test_control.py and test_faults.py.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

import run
from harness import catalog, compare, device, faults

RTOLS = (1e-5, 1e-4, 1e-3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 bench_torch/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    ap.add_argument("--fault", choices=faults.FAULTS)
    args = ap.parse_args(argv)
    bench = catalog.benchmark()
    cell = catalog.workload(bench, args.workload)
    conf = catalog.config(cell["config"])
    mix = catalog.traffic(cell["traffic"])
    import torch

    device.require(cell["chips"])
    card = device.Card(torch.device("cuda:0"))
    run.caches_in_checkout()
    sys.path.insert(0, str(catalog.ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = float(min(max(mix["dt"] * mix["rate"], 0.0), conf["scene"]["max_dt"]))
    name = conf["program"]["transfers"][mix["transfer"]]["reference"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        with (faults.planted(args.fault, name) if args.fault
              else contextlib.nullcontext()):
            prog = run.Program(conf, mix["transfer"], seed)
            loop = run.Loop(prog, dt, mix["check_every"], card)
            loop.warm_up(mix["warmup_steps"], False)
            loop.window(args.seconds, None)
        inp = {k: getattr(loop.prev, k) for k in prog.fields}
        out = {k: getattr(loop.state, k) for k in prog.fields}
        steps, failed = loop.steps, loop.failed
        del loop
        gc.collect()
        card.empty_cache()
        t1 = time.perf_counter()
        ref = prog.reference(conf["scene"], inp, dt)
        card.sync()
        t_ref = time.perf_counter() - t1
        line = {"seed": seed, "fault": args.fault, "steps": steps, "failed": failed, "ref_s": t_ref,
                "program": {str(r): compare.numbers(out, ref, prog.fields, r) for r in RTOLS}}
        del out
        if args.control and not args.fault:
            ctl = prog.reference(conf["scene"], inp, dt, torch.bfloat16)
            line["control"] = {str(r): compare.numbers(ctl, ref, prog.fields, r) for r in RTOLS}
            del ctl
        del inp, ref
        gc.collect()
        card.empty_cache()
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
