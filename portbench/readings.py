"""The readings that set the limits of the comparison: per seed, the
numbers of the program's answer against the reference, and on the first
seeds those of the lower-precision control's (the reference with its
stage products stored in bfloat16, ``ReferenceEngine(lowp=True)``), on
the cell's own configuration and traffic.

    python3 portbench/readings.py --workload <cell> --seeds 1 2 3 [--control 3]

The program runs on the card in this process; the control and the checks
run on the configuration's reference (``check.REFERENCES``), in processes
of their own: on NumPy on the host, on PyTorch in one process on the
card. Prints one JSON line per seed and side."""

import argparse
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _HERE]
sys.path.insert(0, os.path.dirname(_HERE))


def program_answer(workload_name: str, seed: int, device, cfg=None,
                   engine=None):
    """(entry, base params, key, products) of the cell's first command
    after its set-up for ``seed``."""
    from portbench.harness import check, main, spec, traffic

    bench = spec.load_benchmark()
    wl = spec.workload(bench, workload_name)
    cfg = cfg if cfg is not None else spec.config(bench, wl["config"])
    mix = spec.traffic(wl["traffic"])
    base = main.base_params(cfg)
    client = main.Client(mix, base, device, engine)
    if client.entry == "reapply":
        client.prime()
    cmds = traffic.commands(seed, mix)
    traffic.warm(mix, cmds)             # the run's set-up draws these
    key, res = main._attempt(client, next(cmds))
    if res is None:
        raise RuntimeError(f"seed {seed}: the command failed")
    return client.entry, base, key, check.result_products(res)


def main_(argv=None) -> int:
    import torch
    from portbench.harness import check, spec

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3,
                    help="read the control on the first this many seeds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench = spec.load_benchmark()
    reference = check.reference_of(spec.config(
        bench, spec.workload(bench, args.workload)["config"]))
    n_ctl = min(args.control, len(args.seeds))
    t0 = time.perf_counter()
    with check.pool(len(args.seeds) * len(check.STAGES), reference) as ex:
        ctl = {}
        jobs = []
        for i, seed in enumerate(args.seeds):
            entry, base, key, prog = program_answer(args.workload, seed, dev)
            jobs.append((seed, "program", check.submit(
                ex, entry, base, key, prog, reference)))
            if i < n_ctl:
                ctl[seed] = (entry, base, key, ex.submit(
                    check.answers_here, entry, base, [key], True))
        for seed, (entry, base, key, fut) in ctl.items():
            (_, prog), = fut.result()
            jobs.append((seed, "control", check.submit(
                ex, entry, base, key, prog, reference)))
        for seed, side, futures in jobs:
            print(json.dumps(dict(workload=args.workload, seed=seed,
                                  side=side, numbers=check.numbers(futures),
                                  seconds=time.perf_counter() - t0)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main_())
