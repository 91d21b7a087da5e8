"""Distributed training: the port's copy of ``repro.distributed``.

``sharding``: the logical-axis rules, parameter and ZeRO specs and the
``shard`` activation constraint, on DTensor; ``pipeline``: GPipe over the
pod axis with ``torch.distributed.pipelining``; ``compression``: the int8
gradient all-reduce with error feedback."""

from .sharding import (AxisRules, default_rules, param_spec_for_path,
                       params_pspecs, params_shardings, rules_for, shard,
                       use_rules)

__all__ = ["AxisRules", "default_rules", "param_spec_for_path",
           "params_pspecs", "params_shardings", "rules_for", "shard",
           "use_rules"]
