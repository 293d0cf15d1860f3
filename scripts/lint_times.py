"""Where reprolint's time goes: the project load and each rule, timed
apart over the paths `make lint` checks, beside one whole `lint()` (the
call `tests/test_reprolint.py::test_lint_runtime_stays_under_budget`
holds to 10 s).

    PYTHONPATH=src python scripts/lint_times.py [--repeat 3]

Prints the number of files, then the best of `--repeat` runs in seconds
of the load, of each rule (RL001-RL005) and of the whole lint.
"""
import argparse
import os
import time

from repro.analysis import DEFAULT_PATHS, RULES, lint
from repro.analysis.project import Project

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def best(fn, repeat):
    out = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return min(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args()
    project = Project.load(ROOT, paths=DEFAULT_PATHS)
    print(f"files {len(project.files)}")
    load = best(lambda: Project.load(ROOT, paths=DEFAULT_PATHS), args.repeat)
    print(f"project load {load:.3f} s")
    for rid in sorted(RULES):
        # each rule on a fresh project: a rule may cache on the project
        def one(rid=rid):
            p = Project.load(ROOT, paths=DEFAULT_PATHS)
            t0 = time.perf_counter()
            list(RULES[rid].fn(p))
            return time.perf_counter() - t0
        t = min(one() for _ in range(args.repeat))
        print(f"{rid} {t:.3f} s")
    print(f"lint {best(lambda: lint(ROOT), args.repeat):.3f} s")


if __name__ == "__main__":
    main()
