"""The port's tools: the reference-parity gate (parity_gate) and the
kernels' phase timer (kernel_phases, run on the card)."""
