"""Distance-metric-learning core (the exact-serving slice needs only the
config and the factor's initialisation)."""
