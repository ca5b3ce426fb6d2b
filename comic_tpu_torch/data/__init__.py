"""Eval preprocessing, caption files and the inference pipeline."""
