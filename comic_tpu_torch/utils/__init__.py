"""Host utilities: metric logging, checkpoint conversion (TF-slim and
reference TF1), the pretrained-encoder registry, archives, natural sort,
and the optional-library import guard."""
