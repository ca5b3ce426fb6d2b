"""InstaPIC-1.1M dataset preparation CLI; counterpart of
comic_tpu/prepro/insta.py (reference
datasets/preprocessing/insta_prepro.py:39-305).

    python -m comic_tpu_torch.prepro.insta --dataset_dir <dir>

Instagram-aware tokenization (usernames collapsed to @username, emoji kept
as escape tokens, hashtags split: the attend2u conventions the reference
adopted), a fixed-size 25,595 vocabulary, a 2,000-post validation split
carved from train with seed 4896, and COCO-style annotation JSONs for
metric scoring.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
from typing import Dict, List

from . import base

pjoin = os.path.join

EMOTICON = re.compile(
    "(([\U00002600-\U000027BF])|([\U0001f300-\U0001f64F])"
    "|([\U0001f680-\U0001f6FF]))")
NOT_EMOTICON = re.compile(r"(\\U([0-9A-Fa-f]){8})|(\\u([0-9A-Fa-f]){4})")
_EMOJI_MARK = "@@emojimark"


def tokenize(sentence) -> List[str]:
    """Instagram caption -> token list (insta_prepro.py:39-58 behavior)."""
    if isinstance(sentence, list):
        sentence = " ".join(sentence)
    s = sentence.replace("#", " #").replace("@", " @").replace("\n", " ")
    s = s.lower()
    s = re.sub(r"@[a-zA-Z0-9._]+", "@username", s)
    s = EMOTICON.sub(_EMOJI_MARK + r"\1 ", s)
    s = s.encode("unicode-escape").decode("ascii")
    s = s.replace(_EMOJI_MARK + "\\", _EMOJI_MARK)
    s = NOT_EMOTICON.sub(" ", s)
    s = re.sub(r"[\-_]", "-", s)
    s = re.sub(r"([!?,\.\"])", " ", s)
    s = re.sub(r"(?<![a-zA-Z0-9])\-(?![a-zA-Z0-9])", "", s)
    s = " ".join(re.split(r"[^a-zA-Z0-9#@'\-]+", s))
    s = s.replace(_EMOJI_MARK, " \\")
    return s.split()


def tokenize_all(train_json: Dict, test1_json: Dict,
                 num_valid: int = 2000) -> List[base.TokenisedImage]:
    """Documented divergence: the seed-4896 shuffle that carves the
    2000-post val split permutes a SORTED post list here, while the
    reference shuffles posts in py2 dict-hash iteration order
    (insta_prepro.py:29-58) — an ordering that cannot be reproduced under
    py3. Artifacts regenerated here are therefore self-consistent but NOT
    byte-identical to the reference's val carve (and hence its vocab);
    use the reference's own wtoi/itow artifacts (Vocabulary.load handles
    them) when scoring against reference-trained insta checkpoints."""
    data: List[base.TokenisedImage] = []
    for user_id, posts in sorted(train_json.items()):
        for post_id, post in sorted(posts.items()):
            img_id = f"{user_id}_@_{post_id}"
            data.append(base.TokenisedImage(
                split="train", filepath=pjoin("images", img_id),
                image_id=img_id, tokens=[tokenize(post["caption"])]))
    rng = random.Random(4896)
    rng.shuffle(data)
    for i in range(min(num_valid, len(data))):
        data[i]["split"] = "val"
    for user_id, posts in sorted(test1_json.items()):
        for post_id, post in sorted(posts.items()):
            img_id = f"{user_id}_@_{post_id}"
            data.append(base.TokenisedImage(
                split="test", filepath=pjoin("images", img_id),
                image_id=img_id, tokens=[tokenize(post["caption"])]))
    return data


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_dir", type=str, required=True)
    p.add_argument("--train_json", type=str, default="json/insta-caption-train.json")
    p.add_argument("--test1_json", type=str, default="json/insta-caption-test1.json")
    p.add_argument("--output_prefix", type=str, default="insta")
    p.add_argument("--vocab_size", type=int, default=25595)
    p.add_argument("--caption_len_thres", type=int, default=15)
    p.add_argument("--num_valid", type=int, default=2000)
    return p


def main(argv=None):
    args = create_parser().parse_args(argv)
    with open(pjoin(args.dataset_dir, args.train_json)) as f:
        train_json = json.load(f)
    with open(pjoin(args.dataset_dir, args.test1_json)) as f:
        test1_json = json.load(f)
    dataset = tokenize_all(train_json, test1_json, args.num_valid)

    prefix = (f"{args.output_prefix}_{{}}_v{args.vocab_size}"
              f"_s{args.caption_len_thres}")
    out_dir = pjoin(args.dataset_dir, "captions")
    counts = base.write_caption_txts(
        dataset, out_dir, prefix,
        caption_len_thres=args.caption_len_thres)
    vocab = base.write_vocab(
        dataset, out_dir, prefix, word_count_thres=0,
        caption_len_thres=args.caption_len_thres,
        vocab_size=args.vocab_size)
    base.write_filename_lists(dataset, out_dir)
    base.write_annotation_jsons(
        dataset, out_dir, name_fmt="insta_testval_{}.json")
    print(f"INFO: splits {counts}, vocab {len(vocab)} entries")
    return counts, vocab


if __name__ == "__main__":
    main()
