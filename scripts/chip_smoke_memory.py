"""Run `chip_smoke.py` with the card's memory printed along the way.

    python3 scripts/chip_smoke_memory.py      # from the repository's root

Runs the whole of ``chip_smoke.main()`` unchanged and adds lines that start
with ``memory:``: after each phase function, the card's allocated and
reserved bytes and the bytes of the CUDA tensors Python can still reach;
before each round-trainer arm and each arm of phase 20 (the training
launcher, `chip_smoke.launcher_arm`) the same; after each such arm, how
often `ops.fasgd_update` was entered and the most that was allocated at
its entry (the serial apply's moment, after its float32 images of n, b,
v).
A tensor held only by a reference cycle shows as allocated bytes above
the reachable ones.  The exit code is the script's own.
"""

import gc
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (sets the allocator's options)

GIB = 2 ** 30


def census(tag):
    """Collect, then print allocated, reserved and reachable CUDA bytes."""
    import torch
    gc.collect()
    storages = {}
    for o in gc.get_objects():
        if isinstance(o, torch.Tensor):
            try:
                if o.is_cuda:
                    s = o.untyped_storage()
                    storages[s.data_ptr()] = s.nbytes()
            except (RuntimeError, NotImplementedError):
                pass            # a functorch wrapper has no storage
    print(f"memory: {tag}: allocated "
          f"{torch.cuda.memory_allocated() / GIB:.2f} GiB, reserved "
          f"{torch.cuda.memory_reserved() / GIB:.2f} GiB, reachable "
          f"{sum(storages.values()) / GIB:.2f} GiB in {len(storages)} "
          f"storages", flush=True)


def main() -> int:
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ops
    entries = {"n": 0, "max": 0}
    fasgd_update = ops.fasgd_update

    def counted_fasgd_update(*args, **kwargs):
        entries["n"] += 1
        entries["max"] = max(entries["max"], torch.cuda.memory_allocated())
        return fasgd_update(*args, **kwargs)

    ops.fasgd_update = counted_fasgd_update
    round_arm = cs.round_arm

    def arm(label, *args, **kwargs):
        census(f"before {label}")
        entries.update(n=0, max=0)
        out = round_arm(label, *args, **kwargs)
        print(f"memory: {label}: fasgd_update entered {entries['n']} times, "
              f"at most {entries['max'] / GIB:.2f} GiB allocated at entry",
              flush=True)
        return out

    cs.round_arm = arm
    launcher_arm = cs.launcher_arm

    def launcher(label, run):
        census(f"before {label}")
        entries.update(n=0, max=0)
        out = launcher_arm(label, run)
        print(f"memory: {label}: fasgd_update entered {entries['n']} times, "
              f"at most {entries['max'] / GIB:.2f} GiB allocated at entry",
              flush=True)
        return out

    cs.launcher_arm = launcher
    for name in [n for n in dir(cs) if n.startswith("phase_")]:
        def after(*args, _f=getattr(cs, name), _name=name, **kwargs):
            out = _f(*args, **kwargs)
            census(f"after {_name}")
            return out
        setattr(cs, name, after)
    return cs.main()


if __name__ == "__main__":
    sys.exit(main())
