"""Tuned per-(model, dataset) hyper-parameters — the port's copy of the
``gcn``, ``gat`` and ``graphsage`` entries of ``cogdl_tpu/configs.py``; applied when
``use_best_config=True`` with precedence defaults < best-config < user
kwargs."""

BEST_CONFIGS = {
    "gcn": {
        "general": {"lr": 0.01, "weight_decay": 5e-4, "epochs": 500,
                    "patience": 100, "hidden_size": 64, "dropout": 0.5},
        "cora": {"hidden_size": 64},
        "citeseer": {"hidden_size": 64, "dropout": 0.5},
        "pubmed": {"hidden_size": 64},
    },
    "gat": {
        "general": {"lr": 0.005, "weight_decay": 5e-4, "epochs": 1000,
                    "patience": 100, "hidden_size": 8, "nhead": 8,
                    "dropout": 0.6, "attn_drop": 0.6},
        "pubmed": {"nhead_last": 8, "weight_decay": 0.001},
    },
    "graphsage": {"general": {"lr": 0.01, "weight_decay": 5e-4, "epochs": 500,
                              "patience": 100, "hidden_size": 64,
                              "dropout": 0.5}},
}
