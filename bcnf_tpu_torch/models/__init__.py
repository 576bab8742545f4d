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
    DualDomainLSTM,
    FeatureNetwork,
    FeatureNetworkStack,
    FullyConnectedFeatureNetwork,
    Identity,
    LSTMFeatureNetwork,
    VerboseLSTM,
)

__all__ = [
    "ActNorm",
    "AffineCoupling",
    "CondRealNVP",
    "CondRealNVP_v2",
    "ConcatenateCondition",
    "DualDomainLSTM",
    "FeatureNetwork",
    "FeatureNetworkStack",
    "FullyConnectedFeatureNetwork",
    "Identity",
    "LSTMFeatureNetwork",
    "NestedMLP",
    "count_params",
    "orthonormal_init",
    "VerboseLSTM",
]
