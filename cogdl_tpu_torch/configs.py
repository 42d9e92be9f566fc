"""Tuned per-(model, dataset) hyper-parameters — the port's copy of the
``gcn``, ``gat``, ``gcnii``, ``appnp``, ``sgc``, ``mixhop``, ``graphsage`` and
``deepergcn`` entries of ``cogdl_tpu/configs.py``; applied when
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
    "gcnii": {
        "general": {"lr": 0.01, "epochs": 1000, "patience": 100,
                    "hidden_size": 64, "dropout": 0.6, "num_layers": 16,
                    "alpha": 0.1, "lmbda": 0.5, "weight_decay": 5e-4},
        "cora": {"num_layers": 64, "dropout": 0.6},
        "citeseer": {"num_layers": 32, "lmbda": 0.6},
        "pubmed": {"num_layers": 16, "lmbda": 0.4},
    },
    "appnp": {
        "general": {"lr": 0.01, "weight_decay": 5e-4, "epochs": 1000,
                    "patience": 100, "hidden_size": 64, "dropout": 0.5,
                    "propagation_steps": 10, "alpha": 0.1},
    },
    "sgc": {"general": {"lr": 0.1, "weight_decay": 1e-5, "epochs": 200,
                        "order": 2}},
    "mixhop": {"general": {"lr": 0.01, "weight_decay": 5e-4, "epochs": 500,
                           "patience": 100, "hidden_size": 64, "dropout": 0.7}},
    "graphsage": {"general": {"lr": 0.01, "weight_decay": 5e-4, "epochs": 500,
                              "patience": 100, "hidden_size": 64,
                              "dropout": 0.5}},
    "deepergcn": {"general": {"lr": 0.005, "weight_decay": 5e-4,
                              "epochs": 500, "patience": 100,
                              "hidden_size": 64, "num_layers": 14,
                              "dropout": 0.2}},
}
