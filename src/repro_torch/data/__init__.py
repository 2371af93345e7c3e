"""Deterministic synthetic data (port of ``repro.data``)."""
from repro_torch.data.pipeline import SyntheticLM, host_shard

__all__ = ["SyntheticLM", "host_shard"]
