"""The executable dense tick and its counter-keyed RNG streams."""
