"""Times the two routes open to HOPE's top singular triplets and to
Spectral's eigenpairs on one network, and checks that they agree.

    python -m cogdl_tpu_torch.scripts.emb_routes [--device cpu]
        [--nodes 10312 --edges 333983 --labels 39]

Run from the repo root: the network is ``chip_smoke.embedding_network``'s
(BlogCatalog's size by default).

* HOPE: ARPACK (``scipy.sparse.linalg.svds``) over a linear operator whose
  products run on the device (the port's route) against a dense float64
  ``torch.linalg.svd`` of the Katz matrix on the device.
* Spectral: a dense float64 ``torch.linalg.eigh`` of the normalised
  Laplacian on the device (the port's route) against scipy's
  ``eigsh(L, k, sigma=0, which="LM")`` on the host, the JAX package's call.

Prints one JSON line: each route's seconds (the device synchronised) and
the largest difference of their singular values or eigenvalues.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import scipy.sparse as sp
import torch


def _timed(fn, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def main(argv=None) -> dict:
    import chip_smoke
    from cogdl_tpu_torch.data.graph import from_coo
    from cogdl_tpu_torch.models.emb.hope import HOPE, device_operator
    from cogdl_tpu_torch.models.emb.spectral import Spectral
    from cogdl_tpu_torch.trainer.trainer import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--nodes", type=int, default=10312)
    ap.add_argument("--edges", type=int, default=333983)
    ap.add_argument("--labels", type=int, default=39)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    A, _ = chip_smoke.embedding_network(args.nodes, args.edges, args.labels)
    coo = A.tocoo()
    graph = from_coo(np.stack([coo.row, coo.col]), num_nodes=args.nodes,
                     edge_weight=coo.data.astype(np.float32))
    out = {"device": (torch.cuda.get_device_name(0)
                      if device.type == "cuda" else "cpu"),
           "nodes": args.nodes, "edges": args.edges}

    from scipy.sparse.linalg import eigsh, svds

    hope = HOPE()
    K, out["hope_katz_s"] = _timed(lambda: hope.katz(graph, device), device)
    k = hope.hidden_size // 2
    (_, s_arpack, _), out["hope_svds_s"] = _timed(
        lambda: svds(device_operator(K), k=k), device)
    s_dense, out["hope_dense_svd_s"] = _timed(
        lambda: torch.linalg.svdvals(K)[:k].cpu().numpy(), device)
    out["hope_sigma_max_diff"] = float(np.abs(np.sort(s_arpack)[::-1]
                                              - s_dense).max())

    spec = Spectral()
    _, out["spectral_eigh_s"] = _timed(
        lambda: spec.train_embeddings(graph, device), device)
    deg = np.asarray(A.sum(1)).ravel()
    Dn = sp.diags(1.0 / np.sqrt(np.maximum(deg, 1e-12)))
    L = sp.eye(args.nodes) - Dn @ A @ Dn
    kk = min(spec.hidden_size, args.nodes - 2)
    (vals, _), out["spectral_eigsh_s"] = _timed(
        lambda: eigsh(L, k=kk, sigma=0, which="LM"), device)
    out["spectral_lambda_max_diff"] = float(np.abs(
        vals - spec.eigenvalues.cpu().numpy()).max())
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
