from .graph import (
    Graph,
    add_self_loops,
    col_norm,
    from_coo,
    pad_to,
    remove_self_loops,
    reverse,
    row_norm,
    sym_norm,
    to_undirected,
)

__all__ = [
    "Graph", "from_coo", "sym_norm", "row_norm", "col_norm",
    "add_self_loops", "remove_self_loops", "to_undirected", "reverse",
    "pad_to",
]
