"""K1 (the CSR SpMM) and K3 (the fused GAT attention pass), with their
plain versions, autograd rules and loader — the port of
``cogdl_tpu/ops/pallas/segment_kernels.py`` for the GCN and GAT slices.

K1 (``cogdl_tpu_torch/csrc/spmm_csr.cu``) replaces the Pallas
``sorted_segment_matmul`` (``cogdl_tpu/ops/pallas/segment_kernels.py:294``).
It computes ``out[r] = Σ_{e in row r} w[e] · x[col[e]]`` over a CSR
structure with the gather fused in.

K3 (``cogdl_tpu_torch/csrc/gat_fused.cu``) replaces ``_gat_pass``
(``segment_kernels.py:975``, kernel body ``_make_gat_pass_kernel``): the
fused GAT scores + softmax + aggregation pass in three modes, ``fwd`` and
``dsd`` over the CSR (grouped by destination) and ``dsrc`` over the CSC
(grouped by source), with the attention-dropout hash of the TPU kernel bit
for bit. Both are bound by bytes on the H100; their sources say what the
simple designs do about that.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` at first use,
one ``nvcc`` a source, all started together, and linked into one library in
``build/cogdl_tpu_torch/`` beside the package, keyed by a hash of the
sources and flags, bound through ``ctypes`` (plain C interface, no PyTorch
headers, so a build takes seconds).

``spmm_csr`` and ``gat_pass`` take their plain versions only for CPU
tensors. A CUDA tensor launches the kernel or raises: there is no fallback.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "cogdl_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# K3 keeps one lane a head
GAT_MAX_HEADS = 32
GAT_MODES = ("fwd", "dsd", "dsrc")


def sources() -> Tuple[Path, ...]:
    """The kernel sources, in a fixed order."""
    return tuple(sorted(CSRC.glob("*.cu")))


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "CUDA toolkit is needed to build the port's kernels")
    return nvcc


def build() -> Tuple[Path, str, float]:
    """Compile the kernel library unless a build of these exact sources and
    flags exists: one ``nvcc -c`` per source, all running at once, then one
    link. Returns ``(path, nvcc stderr, seconds)``; the log holds
    ``-Xptxas -v``'s register and spill lines and is empty when the library
    was already built. Raises with nvcc's stderr if a step fails."""
    srcs = sources()
    digest = hashlib.sha256(
        b"".join(p.name.encode() + p.read_bytes() for p in srcs)
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libcogdl_kernels_{digest}.so"
    if lib.exists():
        return lib, "", 0.0
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest}.{os.getpid()}"
    objs = [BUILD_DIR / f"{p.stem}_{tag}.o" for p in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for p, o in zip(srcs, objs)]
    logs = []
    failed = []
    for p, proc in zip(srcs, procs):
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {p} (exit {proc.returncode}):"
                          f"\n{err}")
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link {lib.name} (exit "
                               f"{link.returncode}):\n{link.stderr}")
        os.replace(tmp, lib)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return lib, "".join(logs), time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.spmm_csr_f32.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.spmm_csr_f32.restype = ctypes.c_int
    lib.gat_pass_f32.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 13
        + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
        + [ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p])
    lib.gat_pass_f32.restype = ctypes.c_int
    for name in ("spmm_csr_error_string", "gat_pass_error_string"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
    return lib


def spmm_csr_reference(row_ptr: torch.Tensor, col: torch.Tensor,
                       w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: ``out[r] = Σ_{e in row r} w[e]·x[col[e]]``
    with gather + ``index_add``. The CPU path and the tests use it; on the
    card it is the yardstick of correctness only."""
    n = row_ptr.numel() - 1
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    row = torch.repeat_interleave(torch.arange(n, device=x.device), counts)
    E = row.numel()
    msg = x.index_select(0, col[:E].long()) * w[:E].unsqueeze(-1)
    return x.new_zeros((n, x.shape[1])).index_add(0, row, msg)


def _check_launch_args(row_ptr, col, w, x):
    dev = x.device
    for name, t, dtype, ndim in (("row_ptr", row_ptr, torch.int32, 1),
                                 ("col", col, torch.int32, 1),
                                 ("w", w, torch.float32, 1),
                                 ("x", x, torch.float32, 2)):
        if t.device != dev:
            raise ValueError(f"spmm_csr: {name} is on {t.device}, x on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"spmm_csr: {name} must be {dtype}, got {t.dtype}")
        if t.ndim != ndim:
            raise ValueError(f"spmm_csr: {name} must be {ndim}-D, got "
                             f"shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"spmm_csr: {name} must be contiguous")
    if col.numel() != w.numel():
        raise ValueError(f"spmm_csr: col has {col.numel()} entries, "
                         f"w {w.numel()}")
    if x.shape[0] != row_ptr.numel() - 1:
        raise ValueError(
            f"spmm_csr: the matrix is square over {row_ptr.numel() - 1} "
            f"rows, x has {x.shape[0]}")
    if max(x.numel(), col.numel()) >= 2 ** 31:
        raise ValueError("spmm_csr: int32 offsets overflow at this size")


def reset_launch_counts() -> None:
    """Set K1's and K3's launch counters to 0."""
    for fn in (spmm_csr, gat_pass):
        fn.launches = 0
        fn.launches_by.clear()


def spmm_csr(row_ptr: torch.Tensor, col: torch.Tensor, w: torch.Tensor,
             x: torch.Tensor, structure: str = "csr") -> torch.Tensor:
    """``out[r] = Σ_{e in [row_ptr[r], row_ptr[r+1])} w[e] · x[col[e]]``.

    ``row_ptr``/``col`` int32, ``w``/``x`` float32, all contiguous, ``x``
    ``[n, F]`` with ``n = row_ptr.numel() - 1``. CUDA tensors run K1 on the
    current stream; CPU tensors run :func:`spmm_csr_reference`.

    Each launch adds one to ``spmm_csr.launches`` and to
    ``spmm_csr.launches_by[(structure, F)]``; ``structure`` names what the
    caller passes, ``"csr"`` (A) or ``"csc"`` (Aᵀ), and only keys that
    count."""
    if not x.is_cuda:
        return spmm_csr_reference(row_ptr, col, w, x)
    _check_launch_args(row_ptr, col, w, x)
    n, F = x.shape
    out = torch.empty((n, F), dtype=torch.float32, device=x.device)
    if n == 0 or F == 0:
        return out
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.spmm_csr_f32(row_ptr.data_ptr(), col.data_ptr(),
                               w.data_ptr(), x.data_ptr(), out.data_ptr(),
                               n, F, stream)
    if err != 0:
        raise RuntimeError(
            f"spmm_csr kernel launch failed: CUDA error {err} "
            f"({lib.spmm_csr_error_string(err).decode()})")
    spmm_csr.launches += 1
    spmm_csr.launches_by[(structure, F)] += 1
    return out


spmm_csr.launches = 0
spmm_csr.launches_by = collections.Counter()


class SpMMFunction(torch.autograd.Function):
    """``Y = A X`` through K1, with the backward ``dX = Aᵀ G`` through K1
    over the transposed structure (CSR of Aᵀ), and ``dw`` — only when asked
    for — as the plain SDDMM ``(G[row] · X[col]).sum(-1)``, the way the JAX
    package's XLA route differentiates the weights.

    Inputs: ``x``, the CSR of A (``fw_ptr``, ``fw_col``, ``fw_w``) and the
    CSR of Aᵀ (``bw_ptr``, ``bw_col``, ``bw_w``); ``dw`` is the gradient of
    ``fw_w``. ``bw_w`` holds the same values in transposed order and is
    treated as a constant."""

    @staticmethod
    def forward(ctx, x, fw_ptr, fw_col, fw_w, bw_ptr, bw_col, bw_w):
        x = x.contiguous()
        # only the dw SDDMM reads x: keep it alive only when dw is asked for
        ctx.save_for_backward(x if ctx.needs_input_grad[3] else None,
                              fw_ptr, fw_col, bw_ptr, bw_col, bw_w)
        return spmm_csr(fw_ptr, fw_col, fw_w, x, structure="csr")

    @staticmethod
    def backward(ctx, g):
        x, fw_ptr, fw_col, bw_ptr, bw_col, bw_w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = spmm_csr(bw_ptr, bw_col, bw_w, g, structure="csc")
        if ctx.needs_input_grad[3]:
            n = fw_ptr.numel() - 1
            row = torch.repeat_interleave(
                torch.arange(n, device=g.device),
                (fw_ptr[1:] - fw_ptr[:-1]).long())
            dw = (g.index_select(0, row)
                  * x.index_select(0, fw_col[: row.numel()])).sum(-1)
        return dx, None, None, dw, None, None, None


# ---------------------------------------------------------------------------
# K3: the fused GAT attention pass
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``(a · b) mod 2³²`` for int64 ``a`` in ``[0, 2³²)`` and a constant
    ``b < 2³²``: ``b`` is split into 16-bit halves so that no product
    overflows int64."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _drop_params(attn_drop: float) -> Tuple[int, float]:
    """The keep threshold on the 32-bit hash and the keep scale, as the TPU
    kernel computes them (``segment_kernels.py:690-692``); the scale is
    rounded to fp32."""
    thresh = int((1.0 - attn_drop) * float(2 ** 32 - 1))
    inv_keep = float(torch.tensor(1.0 / (1.0 - attn_drop), dtype=torch.float32))
    return thresh, inv_keep


def dropout_keep_reference(orig: torch.Tensor, seed: torch.Tensor, H: int,
                           attn_drop: float) -> torch.Tensor:
    """K3's attention-dropout scales ``[nnz, H]``: ``1/(1-p)`` where the
    edge and head are kept, else 0. The hash of the TPU kernel
    (``segment_kernels.py:819-828``) in int64 arithmetic mod 2³²: key
    ``uint32(orig) ^ seed``, then ``key·H + h`` through a multiply-add and
    the murmur3 finaliser."""
    thresh, inv_keep = _drop_params(attn_drop)
    ek = (orig.long() & _M32) ^ (seed.long().reshape(()) & _M32)
    hx = (ek[:, None] * H + torch.arange(H, device=orig.device)) & _M32
    hx = (_mul32(hx, 747796405) + 2891336453) & _M32
    hx = hx ^ (hx >> 16)
    hx = _mul32(hx, 0x85EBCA6B)
    hx = hx ^ (hx >> 13)
    hx = _mul32(hx, 0xC2B2AE35)
    hx = hx ^ (hx >> 16)
    return torch.where(hx < thresh, inv_keep, 0.0).float()


def gat_pass_reference(mode: str, ptr, idx, orig, sd, ss, smax, h2,
                       dagg=None, dden=None, *, alpha: float,
                       attn_drop: float = 0.0, seed=None,
                       with_keep: bool = False):
    """Plain PyTorch version of K3 with gathers and ``index_add``, per edge
    in the order of the JAX kernel's formulas (``segment_kernels.py:642-970``).
    The CPU path and the tests use it; on the card it is the yardstick of
    correctness only. Arguments and results as :func:`gat_pass`."""
    n, H = ptr.numel() - 1, sd.shape[1]
    HD = h2.shape[1]
    D = HD // H
    grp = torch.repeat_interleave(torch.arange(n, device=sd.device),
                                  (ptr[1:] - ptr[:-1]).long())
    E = grp.numel()
    nbr = idx[:E].long()
    dst, src = (nbr, grp) if mode == "dsrc" else (grp, nbr)
    sd_e = sd.index_select(0, dst)
    pre = sd_e + ss.index_select(0, src)
    slope = torch.where(pre > 0, 1.0, alpha)
    m = sd_e + smax
    m = torch.where(m > 0, m, alpha * m)
    ex = torch.exp(pre * slope - m)
    keep = (dropout_keep_reference(orig[:E], seed, H, attn_drop)
            if attn_drop > 0.0 else None)
    exn = ex if keep is None else ex * keep
    if mode == "fwd":
        msg = h2.index_select(0, src).view(E, H, D) * exn[:, :, None]
        outs = (h2.new_zeros((n, HD)).index_add(0, grp, msg.view(E, HD)),
                sd.new_zeros((n, H)).index_add(0, grp, ex))
    else:
        dagg_e = dagg.index_select(0, dst).view(E, H, D)
        dex = (dagg_e * h2.index_select(0, src).view(E, H, D)).sum(-1)
        if keep is not None:
            dex = dex * keep
        ds = (dex + dden.index_select(0, dst)) * ex * slope
        dhead = sd.new_zeros((n, H)).index_add(0, grp, ds)
        if mode == "dsd":
            outs = (dhead,)
        else:
            dh2 = h2.new_zeros((n, HD)).index_add(
                0, grp, (dagg_e * exn[:, :, None]).view(E, HD))
            outs = (dh2, dhead)
    if with_keep:
        outs += (keep if keep is not None else ex.new_ones((E, H)),)
    return outs


def _check_gat_args(mode, tensors, n, H, HD):
    dev = tensors["sd"].device
    for name, t in tensors.items():
        if t is None:
            raise ValueError(f"gat_pass[{mode}]: {name} is required")
        if t.device != dev:
            raise ValueError(f"gat_pass: {name} is on {t.device}, sd on {dev}")
        want = torch.int32 if name in ("ptr", "idx", "orig") else (
            torch.int64 if name == "seed" else torch.float32)
        if t.dtype != want:
            raise TypeError(f"gat_pass: {name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"gat_pass: {name} must be contiguous")
    shapes = {"sd": (n, H), "ss": (n, H), "smax": (H,), "h2": (n, HD),
              "dagg": (n, HD), "dden": (n, H), "seed": (1,)}
    for name, shape in shapes.items():
        t = tensors.get(name)
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"gat_pass: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    nnz = tensors["idx"].numel()
    if "orig" in tensors and tensors["orig"].numel() != nnz:
        raise ValueError(f"gat_pass: orig has {tensors['orig'].numel()} "
                         f"entries, idx {nnz}")
    if max(n * HD, nnz * H) >= 2 ** 31:
        raise ValueError("gat_pass: int32 offsets overflow at this size")


def gat_pass(mode: str, ptr: torch.Tensor, idx: torch.Tensor,
             orig: Optional[torch.Tensor], sd: torch.Tensor, ss: torch.Tensor,
             smax: torch.Tensor, h2: torch.Tensor,
             dagg: Optional[torch.Tensor] = None,
             dden: Optional[torch.Tensor] = None, *, alpha: float,
             attn_drop: float = 0.0, seed: Optional[torch.Tensor] = None,
             with_keep: bool = False) -> Tuple[torch.Tensor, ...]:
    """One K3 pass over the grouping ``ptr``/``idx`` (int32; the CSR of the
    graph for ``fwd`` and ``dsd``, its CSC for ``dsrc``), ``orig`` the int32
    position of each edge in the graph's edge list (the dropout key).

    ``sd``/``ss`` ``[n, H]`` are the score halves, ``smax`` ``[H]`` the max
    of ``ss`` over all rows, ``h2`` ``[n, H·D]`` the transformed features;
    the backward modes also take ``dagg = g/den`` ``[n, H·D]`` and
    ``dden = −Σ_d g·out/den`` ``[n, H]``. ``seed`` is a one-element int64
    tensor, read when ``attn_drop > 0``. Returns ``(num, den)`` for ``fwd``,
    ``(dsd,)`` for ``dsd``, ``(dh2, dss)`` for ``dsrc``, and with
    ``with_keep`` also the ``[nnz, H]`` keep scales the pass used.

    CUDA tensors run K3 on the current stream; CPU tensors run
    :func:`gat_pass_reference`. Each launch adds one to
    ``gat_pass.launches`` and ``gat_pass.launches_by[(mode, H, D)]``."""
    if mode not in GAT_MODES:
        raise ValueError(f"gat_pass: mode must be one of {GAT_MODES}, got "
                         f"{mode!r}")
    if not sd.is_cuda:
        return gat_pass_reference(mode, ptr, idx, orig, sd, ss, smax, h2,
                                  dagg, dden, alpha=alpha,
                                  attn_drop=attn_drop, seed=seed,
                                  with_keep=with_keep)
    n, H = sd.shape
    HD = h2.shape[1]
    if not 1 <= H <= GAT_MAX_HEADS or HD % H:
        raise ValueError(f"gat_pass: the kernel takes 1 <= H <= "
                         f"{GAT_MAX_HEADS} heads dividing H·D, got H={H}, "
                         f"H·D={HD}")
    D = HD // H
    drop = attn_drop > 0.0
    tensors = {"ptr": ptr, "idx": idx, "sd": sd, "ss": ss, "smax": smax,
               "h2": h2}
    if mode != "fwd":
        tensors.update(dagg=dagg, dden=dden)
    if drop:
        tensors.update(orig=orig, seed=seed)
    _check_gat_args(mode, tensors, n, H, HD)
    if ptr.numel() != n + 1:
        raise ValueError(f"gat_pass: ptr has {ptr.numel()} entries for {n} "
                         "rows")
    nnz = idx.numel()
    out_vec = (None if mode == "dsd"
               else torch.empty((n, HD), dtype=torch.float32, device=sd.device))
    out_head = torch.empty((n, H), dtype=torch.float32, device=sd.device)
    keep = (torch.empty((nnz, H), dtype=torch.float32, device=sd.device)
            if with_keep else None)
    thresh, inv_keep = _drop_params(attn_drop) if drop else (0, 1.0)
    lib = load_library()

    def p(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(sd.device):
        stream = torch.cuda.current_stream(sd.device).cuda_stream
        err = lib.gat_pass_f32(
            GAT_MODES.index(mode), p(ptr), p(idx), p(orig) if drop else None,
            p(seed) if drop else None, p(sd), p(ss), p(smax), p(h2),
            p(dagg) if mode != "fwd" else None,
            p(dden) if mode != "fwd" else None, p(out_vec), p(out_head),
            p(keep), n, H, D, float(alpha), inv_keep, thresh, int(drop),
            stream)
    if err != 0:
        raise RuntimeError(
            f"gat_pass[{mode}] kernel launch failed: CUDA error {err} "
            f"({lib.gat_pass_error_string(err).decode()})")
    gat_pass.launches += 1
    gat_pass.launches_by[(mode, H, D)] += 1
    outs = {"fwd": (out_vec, out_head), "dsd": (out_head,),
            "dsrc": (out_vec, out_head)}[mode]
    return outs + ((keep,) if with_keep else ())


gat_pass.launches = 0
gat_pass.launches_by = collections.Counter()


class GATFusedFunction(torch.autograd.Function):
    """``out[r,h,:] = Σ_e softmax_e(lrelu(sd[r,h] + ss[c_e,h])) · keep ·
    h2[c_e,h,:]`` through K3, the port of the custom VJP ``gat_fused_p``
    (``segment_kernels.py:1200-1232``): the forward runs the ``fwd`` pass
    and divides by the clamped denominator in plain torch; the backward runs
    ``dsd`` over the CSR and ``dsrc`` over the CSC and returns the
    cotangents of ``sd``, ``ss`` and ``h2`` (``h2`` flat ``[n, H·D]``).

    Inputs: ``sd``, ``ss``, ``h2``; the CSR (``fw_ptr``, ``fw_col``,
    ``fw_orig``) and CSC (``bw_ptr``, ``bw_col``, ``bw_orig``) of
    ``prepare_spmm``; ``seed`` (one-element int64 tensor or None),
    ``alpha``, ``attn_drop``. The softmax shift ``lrelu(sd + max ss)`` is
    exact and gets no gradient."""

    @staticmethod
    def forward(ctx, sd, ss, h2, fw_ptr, fw_col, fw_orig, bw_ptr, bw_col,
                bw_orig, seed, alpha: float, attn_drop: float):
        sd, ss, h2 = sd.contiguous(), ss.contiguous(), h2.contiguous()
        n, H = sd.shape
        smax = ss.detach().amax(0).contiguous()
        num, den = gat_pass("fwd", fw_ptr, fw_col, fw_orig, sd, ss, smax, h2,
                            alpha=alpha, attn_drop=attn_drop, seed=seed)
        den = den.clamp_min(1e-16)
        out = (num.view(n, H, -1) / den[:, :, None]).view(n, -1)
        ctx.save_for_backward(sd, ss, h2, smax, den, out, fw_ptr, fw_col,
                              fw_orig, bw_ptr, bw_col, bw_orig, seed)
        ctx.alpha, ctx.attn_drop = alpha, attn_drop
        return out

    @staticmethod
    def backward(ctx, g):
        (sd, ss, h2, smax, den, out, fw_ptr, fw_col, fw_orig, bw_ptr, bw_col,
         bw_orig, seed) = ctx.saved_tensors
        n, H = sd.shape
        g = g.contiguous().view(n, H, -1)
        dagg = (g / den[:, :, None]).reshape(n, -1)
        dden = (-(g * out.view(n, H, -1)).sum(2) / den).contiguous()
        kw = dict(alpha=ctx.alpha, attn_drop=ctx.attn_drop, seed=seed)
        dsd = dss = dh2 = None
        if ctx.needs_input_grad[0]:
            (dsd,) = gat_pass("dsd", fw_ptr, fw_col, fw_orig, sd, ss, smax,
                              h2, dagg, dden, **kw)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dh2, dss = gat_pass("dsrc", bw_ptr, bw_col, bw_orig, sd, ss, smax,
                                h2, dagg, dden, **kw)
        return (dsd, dss, dh2) + (None,) * 9
