"""Preprocessing, caption files and the training and inference pipelines."""
