"""The paper's primary contribution: CNNSelect — SLA-aware probabilistic
model selection over a zoo of models with (accuracy, mu, sigma) profiles
— plus the greedy/static/random/oracle baselines it is evaluated against,
online performance profiling, and cold/hot model lifecycle management.
"""

from repro_torch.core.selection import (
    BatchSelection,
    CNNSelectPolicy,
    GreedyPolicy,
    ModelProfile,
    OraclePolicy,
    Policy,
    RandomPolicy,
    SelectionResult,
    StaticPolicy,
    cnnselect,
    cnnselect_batch,
    greedy_select,
    make_policy,
    policy_names,
    static_select,
    random_select,
    oracle_select,
)
from repro_torch.core.profiles import OnlineProfile, ProfileStore
from repro_torch.core.zoo import ModelZoo, ZooEntry

__all__ = [
    "ModelProfile", "SelectionResult", "cnnselect", "cnnselect_batch",
    "greedy_select", "static_select", "random_select", "oracle_select",
    "Policy", "BatchSelection", "CNNSelectPolicy", "GreedyPolicy",
    "RandomPolicy", "StaticPolicy", "OraclePolicy", "make_policy",
    "policy_names",
    "OnlineProfile", "ProfileStore", "ModelZoo", "ZooEntry",
]
