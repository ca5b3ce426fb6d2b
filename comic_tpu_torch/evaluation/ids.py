"""Image-id sort key shared by the scorers (the port's own copy of
comic_tpu.evaluation.ids).

COCO ids are ints; insta-style ids are arbitrary strings. Scorers iterate
images in a deterministic order, so the sort key must tolerate either."""


def id_sort_key(k):
    """ints (COCO) before strings (insta); stable mixed-type sort.

    Int keys MUST sort numerically (the reference's py2 sorted() over int
    ids): the SCST joint gts/res dict is split back into greedy/sample
    blocks by NUMERIC position (scorers.get_hypo_scores), so a
    lexicographic order (0,1,10,11,...,2,...) would misassign every score
    once the dict holds >= 10 keys, i.e. at any real operating point
    (batch 10 x beam 7 = 80 keys)."""
    return (1, "", str(k)) if isinstance(k, str) else (0, k, "")
