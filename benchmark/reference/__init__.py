"""The plain reference that decides each run's `correct`.

Plain PyTorch in float32 with TF32 off, written from the published
mathematics of the conditional RealNVP (psaegert/bcnf `CondRealNVP_v2`):
each feature network in a file of its own named by its type (`encoders/`;
the LSTMs as time loops), every coupling, ActNorm and mix of the flow both
ways, the NLL, global-norm clipping and Adam. It reads
the weights the benchmark made, in their tree layout, and works out
everything else itself (the condition projections, z from the request's
seed, the dropout masks from the step's seed). It imports nothing of the
program under test.
"""
