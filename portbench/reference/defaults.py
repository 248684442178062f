"""Frozen copy of smcpp_tpu_torch/defaults.py, the plain PyTorch and NumPy
code the benchmark's reference recomputes the port's set-up with.
Later changes to the port do not reach it.  The original docstring
follows.

Numeric defaults, mirroring SMC++ smcpp/defaults.py."""

additional_knots = []
regularization_penalty = 6
xtol = 0.1
ftol = 1e-4
pieces = 100
knots = 8
minimum = 1e-4
maximum = 1e4
spline = "piecewise"
cores = None
perplexity_threshold = 0.5
minimum_population_size = 1e-3
maximum_population_size = 1e3

# Numerical floors used throughout the reference
# (src/inference_manager.cpp:65-66, src/transition.cpp:244-252, src/hmm.cpp:92-94).
pi_floor = 1e-20
transition_floor = 1e-20
transition_beta = 1e-5
emission_floor = 1e-10

# A finite stand-in for the infinite width of the terminal (flat) piece of the
# rate function.  Chosen so that rate * ada * BIG stays below the float64
# overflow threshold for any clipped model (ada <= 1e3, rate <= ~2e4) while
# exp(-ada * BIG) is exactly 0.0, which makes every "t = infinity" branch of
# the closed-form integrals collapse to the correct limit automatically.
BIG_T = 1e250
