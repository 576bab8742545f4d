"""Ops of the port: dense layers, the LSTM, and the hand-written CUDA kernels (`csrc/`)."""
