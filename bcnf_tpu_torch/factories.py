"""String -> feature-network registry driven by the YAML config schema
(port of `bcnf_tpu/factories.py`, reference `src/bcnf/factories.py:33-58`).

Every name of the JAX registry is served.
"""

from __future__ import annotations

from typing import Any

from bcnf_tpu_torch.models.cnn import CNN
from bcnf_tpu_torch.models.feature_network import (
    ConcatenateCondition,
    DualDomainFC,
    DualDomainLSTM,
    DualDomainTransformer,
    FeatureNetwork,
    FrExpFeatureNetwork,
    FullyConnectedFeatureNetwork,
    Identity,
    LSTMFeatureNetwork,
    Transformer,
    VerboseLSTM,
)
from bcnf_tpu_torch.models.layers import AnyGLU, FFTEnrichLayer, FFTLayer, LinearFFTEnriched


class FeatureNetworkFactory:
    REGISTRY: dict[str, type] = {  # the JAX registry's names (`bcnf_tpu/factories.py:34-49`)
        "FullyConnected": FullyConnectedFeatureNetwork,
        "CNN": CNN,
        "LSTM": LSTMFeatureNetwork,
        "Transformer": Transformer,
        "ConcatenateCondition": ConcatenateCondition,
        "FrExpFeatureNetwork": FrExpFeatureNetwork,
        "DualDomainLSTM": DualDomainLSTM,
        "DualDomainTransformer": DualDomainTransformer,
        "DualDomainFC": DualDomainFC,
        "VerboseLSTM": VerboseLSTM,
        "AnyGLU": AnyGLU,
        "FFTLayer": FFTLayer,
        "FFTEnrichLayer": FFTEnrichLayer,
        "LinearFFTEnriched": LinearFFTEnriched,
    }

    @staticmethod
    def get_feature_network(network: str | None, network_kwargs: dict[str, Any]) -> FeatureNetwork:
        if network is None:
            return Identity()
        cls = FeatureNetworkFactory.REGISTRY.get(network)
        if cls is None:
            raise NotImplementedError(f"Feature network {network} not implemented")
        kwargs = dict(network_kwargs)
        if cls is not ConcatenateCondition:
            # configs pass `input_size: null` markers only meaningful for
            # ConcatenateCondition (e.g. `trajectory_LSTM_large.yaml:42-44`)
            kwargs = {
                k: v for k, v in kwargs.items()
                if not (v is None and k in ("input_size", "output_size"))
            }
        return cls(**kwargs)
