"""Folding schemes over HyperPlonk: Protostar and Sangria."""
