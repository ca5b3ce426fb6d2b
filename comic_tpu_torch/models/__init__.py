"""Encoder, attention, cells, decoder, the model spec and its losses."""
