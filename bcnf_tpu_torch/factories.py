"""String -> feature-network registry driven by the YAML config schema
(port of `bcnf_tpu/factories.py`, reference `src/bcnf/factories.py:33-58`).

Ported types: `ConcatenateCondition`, `LSTM`, `FullyConnected`,
`VerboseLSTM` and `DualDomainLSTM`. The other names the JAX registry knows
(`CNN`, `Transformer`, `FrExpFeatureNetwork`, `DualDomainTransformer`,
`DualDomainFC` and the layer types) raise `NotImplementedError` until their
slice lands (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any

from bcnf_tpu_torch.models.feature_network import (
    ConcatenateCondition,
    DualDomainLSTM,
    FeatureNetwork,
    FullyConnectedFeatureNetwork,
    Identity,
    LSTMFeatureNetwork,
    VerboseLSTM,
)


class FeatureNetworkFactory:
    REGISTRY: dict[str, type] = {  # the JAX registry's names (`bcnf_tpu/factories.py:34-49`)
        "FullyConnected": FullyConnectedFeatureNetwork,
        "LSTM": LSTMFeatureNetwork,
        "ConcatenateCondition": ConcatenateCondition,
        "DualDomainLSTM": DualDomainLSTM,
        "VerboseLSTM": VerboseLSTM,
    }

    @staticmethod
    def get_feature_network(network: str | None, network_kwargs: dict[str, Any]) -> FeatureNetwork:
        if network is None:
            return Identity()
        cls = FeatureNetworkFactory.REGISTRY.get(network)
        if cls is None:
            raise NotImplementedError(
                f"Feature network {network} is not ported yet (ROADMAP.md, 'Other conditioners')"
            )
        kwargs = dict(network_kwargs)
        if cls is not ConcatenateCondition:
            # configs pass `input_size: null` markers only meaningful for
            # ConcatenateCondition (e.g. `trajectory_LSTM_large.yaml:42-44`)
            kwargs = {
                k: v for k, v in kwargs.items()
                if not (v is None and k in ("input_size", "output_size"))
            }
        return cls(**kwargs)
