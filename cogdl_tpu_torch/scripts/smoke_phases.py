"""Run chosen phases of one checkout's ``chip_smoke.py`` on the card and
time each: the way to compare what two trees of the script differ in,
inside one call, without running every phase.

    python cogdl_tpu_torch/scripts/smoke_phases.py CHECKOUT PHASE[:ARG=V1,V2] ...

``CHECKOUT`` is a directory holding ``chip_smoke.py`` and the
``cogdl_tpu_torch`` it drives (a ``git archive`` of a commit, say). Each
``PHASE`` names a ``phase_`` function of that ``chip_smoke.py``; after a
colon come keyword arguments whose values are tuples of strings, ``;`` between
two of them (``rest_quality:models=sign,gdc_gcn``). The phases run in the
order given, after the script's ``phase_device`` and ``phase_build`` and
with its matmul settings, each timed by the script's ``timed``. A phase
that raises is reported and the next one runs. Run it as a file, not with
``-m``: the checkout's package is the one imported. The last line is
``[phases] {json}``: the checkout, seconds by phase, their total, and the
phases that failed. Exits 1 if one failed or no card is visible.

To compare a parent with a change, run it in turns in one call (parent,
change, parent, change), each with the phases the two trees differ in.
"""

import json
import os
import sys
import time
import traceback


def parse(spec: str):
    """``NAME[:ARG=V1,V2;ARG2=V]`` → ``(NAME, {ARG: (V1, V2), ...})``."""
    name, _, rest = spec.partition(":")
    kw = {}
    for item in filter(None, rest.split(";")):
        key, _, values = item.partition("=")
        kw[key] = tuple(v for v in values.split(",") if v)
    return name, kw


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    checkout = os.path.abspath(argv[0])
    phases = [parse(s) for s in argv[1:]]
    import torch

    if not torch.cuda.is_available():
        print("smoke_phases: torch sees no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [checkout] + [p for p in sys.path
                                if os.path.abspath(p or ".") != here]
    os.chdir(checkout)
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cs.timed(cs.phase_device)
    cs.timed(cs.phase_build)
    seconds, failed = {}, []
    for name, kw in phases:
        t0 = time.perf_counter()
        try:
            cs.timed(getattr(cs, f"phase_{name}"), device, **kw)
        except Exception:           # report it and time the next one
            traceback.print_exc()
            failed.append(name)
        seconds[name] = round(time.perf_counter() - t0, 1)
    print("[phases] " + json.dumps({
        "checkout": checkout, "seconds": seconds,
        "total": round(sum(seconds.values()), 1), "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
