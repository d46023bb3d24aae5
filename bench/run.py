"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

Runs one cell of ``BENCHMARK.json`` on this machine's cards and prints
its result as one JSON line, the last line of standard output:

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer ones from a run with a
profiled stretch. Every run checks what its window produced against the
plain reference in ``bench/reference`` and prints each number compared
beside its limit as its last lines on standard error. The kernels build
into ``build/`` inside the checkout on a cell's first run there.

Exits non-zero and prints no result without enough CUDA cards, or if the
JAX package or JAX itself was loaded by the time the window closed.
"""

import time

T_START = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# every build and kernel cache at a fixed place inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = os.path.join(ROOT, "build", _sub)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    from bench.harness import cell as cells
    from bench.harness.registry import Benchmark

    bench = Benchmark(ROOT)
    try:
        cell = bench.cell(args.workload)
    except KeyError as e:
        print(e, file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()} usable",
              file=sys.stderr)
        return 2
    result = cells.run(cell, seed=args.seed, seconds=args.seconds,
                       trace=bool(args.trace), device=torch.device("cuda"),
                       t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}; the benchmark "
              f"measures the port alone", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
