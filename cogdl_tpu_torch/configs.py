"""Tuned per-(model, dataset) hyper-parameters — the port's copy of the
``gcn``, ``gat``, ``gcnii``, ``appnp``, ``grand``, ``sgc``, ``mixhop``,
``graphsage``, ``sign``, ``deepergcn``, ``dropedge_gcn``, ``revgcn`` and
``gin`` entries of ``cogdl_tpu/configs.py``; applied when
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
    "grand": {
        "general": {"lr": 0.01, "weight_decay": 5e-4, "epochs": 1000,
                    "patience": 200, "hidden_size": 32,
                    "sample": 4, "order": 8, "tem": 0.5, "lam": 1.0,
                    "input_dropout": 0.5, "hidden_dropout": 0.5},
        "cora": {"order": 8, "sample": 4},
        "citeseer": {"order": 2, "sample": 2},
        "pubmed": {"order": 5, "sample": 4, "hidden_dropout": 0.8},
    },
    "sgc": {"general": {"lr": 0.1, "weight_decay": 1e-5, "epochs": 200,
                        "order": 2}},
    "mixhop": {"general": {"lr": 0.01, "weight_decay": 5e-4, "epochs": 500,
                           "patience": 100, "hidden_size": 64, "dropout": 0.7}},
    "graphsage": {"general": {"lr": 0.01, "weight_decay": 5e-4, "epochs": 500,
                              "patience": 100, "hidden_size": 64,
                              "dropout": 0.5}},
    "sign": {"general": {"lr": 0.01, "weight_decay": 5e-4, "epochs": 300,
                         "patience": 50, "hidden_size": 64, "num_hops": 3,
                         "dropout": 0.5}},
    "deepergcn": {"general": {"lr": 0.005, "weight_decay": 5e-4,
                              "epochs": 500, "patience": 100,
                              "hidden_size": 64, "num_layers": 14,
                              "dropout": 0.2}},
    "dropedge_gcn": {"general": {"lr": 0.01, "weight_decay": 5e-4,
                                 "epochs": 400, "patience": 100,
                                 "dropedge_rate": 0.2, "num_layers": 4}},
    "revgcn": {"general": {"lr": 0.01, "weight_decay": 5e-4, "epochs": 500,
                           "patience": 100, "num_layers": 8,
                           "hidden_size": 64}},
    "gin": {"general": {"lr": 0.005, "weight_decay": 5e-4, "epochs": 300,
                        "patience": 50, "hidden_size": 32, "num_layers": 5}},
}
