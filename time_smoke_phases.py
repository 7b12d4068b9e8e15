"""Times each phase of a chip_smoke.py run, so that two checkouts' smoke
runs can be compared phase by phase on one card.

It loads the chip_smoke.py at PATH (this checkout's, or an older
checkout's unpacked beside it, with that checkout's own package first on
the path), wraps each of this checkout's `chip_smoke.PHASE_FUNCTIONS` that
the target defines in a wall-clock timer, runs the target's whole default
run (`main([])`, every phase, its kernels line and result line), and then
prints `phase seconds: {...}` (the total, and each phase function's
seconds) as its last line.  This checkout's own chip_smoke.py prints the
same line by itself, before its kernels line.

    python3 time_smoke_phases.py PATH/chip_smoke.py
"""

from __future__ import annotations

import importlib.util
import pathlib
import sys
import time


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit("usage: time_smoke_phases.py PATH/chip_smoke.py")
    target = pathlib.Path(argv[0]).resolve()
    # this checkout's timing helpers (chip_smoke.py imports no package at
    # module level), then the target with its own package first
    timing = _load(pathlib.Path(__file__).resolve().parent / "chip_smoke.py",
                   "smoke_timing")
    sys.path.insert(0, str(target.parent))
    smoke = _load(target, "chip_smoke")
    seconds = timing.time_phases(vars(smoke))
    t = time.perf_counter()
    rc = smoke.main([])
    print(timing.phase_seconds_line(seconds, time.perf_counter() - t),
          flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
