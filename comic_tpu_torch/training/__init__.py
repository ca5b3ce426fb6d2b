"""Checkpoints, optimizer, schedules and the XE training driver."""
