from bcnf_tpu_torch.models.cnf import (
    ActNorm,
    AffineCoupling,
    CondRealNVP,
    CondRealNVP_v2,
    NestedMLP,
    count_params,
    orthonormal_init,
)
from bcnf_tpu_torch.models.feature_network import (
    ConcatenateCondition,
    FeatureNetwork,
    FeatureNetworkStack,
    Identity,
    LSTMFeatureNetwork,
)

__all__ = [
    "ActNorm",
    "AffineCoupling",
    "CondRealNVP",
    "CondRealNVP_v2",
    "ConcatenateCondition",
    "FeatureNetwork",
    "FeatureNetworkStack",
    "Identity",
    "LSTMFeatureNetwork",
    "NestedMLP",
    "count_params",
    "orthonormal_init",
]
