"""The port's tools: the reference-parity gate (parity_gate), the kernels'
phase timer (kernel_phases, run on the card), and the bench's companions
(serve_check, batch_sweep, beam_sweep on the card; loader_bench on the
host)."""
