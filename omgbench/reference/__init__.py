"""The plain float64 reference: one module a problem kind, torch and numpy
only, nothing of the program.

A problem kind's module has ``prepare(inputs, device)``, which rebuilds the
fine operator from the inputs the benchmark made (never from what the
program made of them), and ``residual_norm(op, b, x)``, ‖b − A x‖₂ in
float64 for one right-hand side ``b`` and one answer ``x``.
"""
