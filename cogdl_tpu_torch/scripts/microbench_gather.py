"""Microbenchmark: what does a gather of 128-float table rows cost inside a
hand-written kernel, against the framework's staged gather? — the port of
``scripts/microbench_gather7.py``.

    python -m cogdl_tpu_torch.scripts.microbench_gather \\
        [A|B|C256|C512|C1024|D|all] [--device cpu] [--rows N --gathered E]

Every stage sums E gathered rows of an ``[N, 128]`` float32 table:

  A. ``ops.gather(t, idx).sum()`` over the whole table — the incumbent: one
     indexed copy to a staged ``[E, 128]`` tensor, then a reduction;
  B. K4 ``gather_block_sum``: indices local to each chunk's own block of
     T = 1024 rows, plain indexed loads (window == block);
  C. K5 ``gather_window_sum``: indices local to a window of 256, 512 or
     1024 rows that the kernel stages in shared memory;
  D. K6 ``gather_rows_sum``: indices over the whole table, every row its own
     asynchronous copy, 8 in flight per warp, at E/16 rows.

B and C rates are window-local: they say what a gather costs once a layout
has confined a chunk's sources to a block or a window. A and D read rows
from anywhere.

Each stage prints one report line (``ms`` per call and ``ns/row``) and the
run ends with one JSON line. Times are CUDA events around ``--iters`` calls
after ``--warmup`` calls on the card; ``--device cpu`` runs the kernels'
plain PyTorch versions against the host clock, for rehearsal only. Table
and indices come from a ``torch.Generator`` seeded with ``--seed``.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from ..ops import gather
from ..ops.cuda import (
    gather_block_sum,
    gather_rows_sum,
    gather_window_sum,
)
from ..trainer.trainer import resolve_device
from ..utils.timing import time_ms

N = 100_352          # table rows
E = 3_145_728        # gathered rows (a multiple of 1024)
T = 1024             # slots per chunk
WINDOWS = (256, 512, 1024)
OUTSTANDING = 8      # stage D: copies in flight per warp
STAGES = ("A", "B") + tuple(f"C{w}" for w in WINDOWS) + ("D",)


class Stage(NamedTuple):
    """One stage: its report name, the rows it gathers, the range of its
    indices, ``fn(table, idx) -> scalar``, and the kernel wrapper it runs
    with that wrapper's ``launches_by`` key (None for stage A, which runs no
    kernel)."""
    name: str
    rows_gathered: int
    index_range: int
    fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    kernel: Optional[Callable] = None
    key: Optional[int] = None


def stage_case(stage: str, rows: int = N, gathered: int = E) -> Stage:
    if stage == "A":
        return Stage("A. ops.gather + sum (full range)", gathered, rows,
                     lambda t, idx: gather(t, idx).sum())
    if stage == "B":
        return Stage(f"B. in-kernel block gather (window={T})", gathered, T,
                     lambda t, idx: gather_block_sum(t, idx, T).sum(),
                     gather_block_sum, T)
    if stage in STAGES and stage.startswith("C"):
        w = int(stage[1:])
        return Stage(f"C. in-kernel shared-memory window (window={w})",
                     gathered, w,
                     lambda t, idx: gather_window_sum(t, idx, w, T).sum(),
                     gather_window_sum, w)
    if stage == "D":
        return Stage(
            f"D. per-row async copy ({OUTSTANDING} outstanding) [E/16]",
            max(gathered // 16 // T, 1) * T, rows,
            lambda t, idx: gather_rows_sum(t, idx, T, OUTSTANDING).sum(),
            gather_rows_sum, OUTSTANDING)
    raise ValueError(f"unknown stage {stage!r}: one of {STAGES}")


def run(stage: str, device=None, rows: int = N, gathered: int = E,
        seed: int = 0, iters: int = 20, warmup: int = 3) -> Dict[str, Any]:
    """Time one stage; returns its report. ``device`` defaults to the card
    and raises when there is none."""
    device = resolve_device(device)
    if gathered % T or rows < T:
        raise ValueError(f"--gathered must be a multiple of {T} and --rows at "
                         f"least {T}, got {gathered} and {rows}")
    name, n, hi, fn = stage_case(stage, rows, gathered)[:4]
    gen = torch.Generator(device=device).manual_seed(seed)
    t = torch.randn((rows, 128), generator=gen, device=device)
    idx = torch.randint(0, hi, (n,), generator=gen, device=device,
                        dtype=torch.int32)
    total = float(fn(t, idx))
    ms = time_ms(lambda: fn(t, idx), device, iters, warmup)
    print(f"{name:52s}: {ms:8.3f} ms   {ms * 1e6 / n:6.3f} ns/row",
          flush=True)
    return {"stage": stage, "name": name, "ms": ms,
            "ns_per_row": ms * 1e6 / n, "rows_gathered": n,
            "gathered_bytes_per_s": n * 512 / (ms * 1e-3), "total": total,
            "calls": 1 + warmup + iters}


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        "cogdl_tpu_torch.scripts.microbench_gather", description=__doc__,
        formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("stage", nargs="?", default="A",
                    choices=STAGES + ("all",))
    ap.add_argument("--rows", type=int, default=N, help="table rows")
    ap.add_argument("--gathered", type=int, default=E,
                    help=f"gathered rows, a multiple of {T}")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                    "PyTorch versions of the kernels)")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = get_parser().parse_args(argv)
    device = resolve_device(args.device)
    stages = STAGES if args.stage == "all" else (args.stage,)
    reports = [run(s, device, args.rows, args.gathered, args.seed,
                   args.iters, args.warmup) for s in stages]
    result = {
        "script": "microbench_gather", "rows": args.rows,
        "gathered": args.gathered, "chunk": T,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "stages": reports}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
