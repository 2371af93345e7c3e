"""Model code of the port: shared primitives, attention (GQA and MLA), the
transformer backbone (dense and MoE), Mamba2 (``ssm``), the hybrid
backbone and the family dispatch."""
