"""Advanced analytics (§4 of the paper): verticalized tables, rollup prefix
tables, frequent items, longest-maximal-pattern, naive Bayes — all expressed
as Datalog programs over the port's tuple engine (port of
``repro.analytics``)."""
from .rollup import (Verticalized, build_rollup_prefix_table, compact_rollup,
                     longest_maximal_pattern, verticalize)
from .nbc import naive_bayes_train, naive_bayes_predict

__all__ = [
    "Verticalized", "verticalize", "build_rollup_prefix_table",
    "compact_rollup", "longest_maximal_pattern",
    "naive_bayes_train", "naive_bayes_predict",
]
