"""The plain reference that decides `correct`: a frozen copy of the port's
plain forms (env step, CBF-QP filter with the plain versions of both
kernels, policy and critic networks, GAE, Clip-PPO loss, clipped Adam),
imports rewritten to this package. It imports nothing of
`sigmarl_tpu_torch` and launches no kernel; it reads the raw map files
that the program ships (`constants._HERE`). The benchmark hands it the
same inputs, weights and draws as the program, and it recomputes every
output from them.
"""
