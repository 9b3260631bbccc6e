"""The paper's primitives, ported: policy, latency model, power-of-two
quantization, Dense/ShiftLinear, the {Mult, Shift} MoE and the deployment
freeze. Importing this package imports no submodule."""
