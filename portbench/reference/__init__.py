"""The benchmark's plain reference: what the port computes, worked out again
in float64 PyTorch and NumPy from the generated data and the model's
parameters.  It imports neither the port nor the JAX package; the Q family
(``grid``, ``ratefunc``, ``transition``, ``csfs``, ``exact``, ``emission``,
``spline``, ``model``) is a frozen copy of the port's plain code."""
