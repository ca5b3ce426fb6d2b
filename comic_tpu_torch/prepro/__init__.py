"""Offline dataset preparation: Karpathy or InstaPIC JSON -> caption txts,
vocabulary JSONs, filename lists, annotation JSONs, the packed HDF5 and the
SCST IDF cache (counterpart of comic_tpu/prepro/). Run as
``python -m comic_tpu_torch.prepro.coco`` (``.insta``, ``.ngrams``)."""
