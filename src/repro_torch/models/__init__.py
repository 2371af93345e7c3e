"""Model code of the port: shared primitives, attention, the dense
transformer backbone and the family dispatch."""
