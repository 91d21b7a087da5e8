"""Half-gates garbled circuits on PyTorch: gates, AND-XOR subcircuits,
the garbler/evaluator drivers, fixed-key AES and the Integer DSL."""
