"""Encoder, attention, cells, decoder and the model spec."""
