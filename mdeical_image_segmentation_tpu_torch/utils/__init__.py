"""Dependency-free codecs and the flax <-> torch parameter bridge."""
