"""Caption tokenization for metric evaluation (the port's own copy of
comic_tpu.evaluation.tokenizer).

The reference shells out to Stanford CoreNLP's PTBTokenizer
(-preserveLines -lowerCase) and strips a fixed punctuation list
(pycocoevalcap/tokenizer/ptbtokenizer.py:24-68). The same interface:

  - ``PTBTokenizer.tokenize({key: [{"caption": ...}]}) -> {key: [str]}``;
  - the CoreNLP jar when Java and the jar are available;
  - otherwise a pure-Python approximation of the PTB lexer (below).

Reference quirk kept on purpose: the reference filters tokens against the
UPPERCASE list ("-LRB-", ...) AFTER the jar lowercased them, so bracket
tokens survive as "-lrb-" / "-rrb-" in the scored captions. The Python
fallback emits the same lowercased bracket tokens.

The fallback follows the CoreNLP 3.4.1 PTBLexer on caption-like text:
contraction splitting ("don't" -> "do n't"), bracket normalization
("(" -> "-lrb-"), latex-style quotes ('"' -> `` / ''), in-word hyphens
kept, numbers with internal separators kept, informal contractions
("gonna" -> "gon na"), unicode letters kept in-word.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import tempfile
from typing import Dict, List

PUNCTUATIONS = ["''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
                ".", "?", "!", ",", ":", "-", "--", "...", ";"]

CORENLP_JAR = "stanford-corenlp-3.4.1.jar"

# CoreNLP default quote/ellipsis normalization (latexQuotes, ptb3Ellipsis)
_CHAR_MAP = {
    "“": " `` ", "”": " '' ",    # curly double quotes
    "‘": " ` ", "’": "'",        # curly single quotes
    "…": " ... ",                # unicode ellipsis
}

# PTB bracket tokens, already lowercase (the jar's -lowerCase applies to its
# output, and the reference's punctuation filter misses the lowercase forms)
_BRACKETS = {"(": " -lrb- ", ")": " -rrb- ", "[": " -lsb- ", "]": " -rsb- ",
             "{": " -lcb- ", "}": " -rcb- "}

_TOKEN = re.compile(
    r"-l[rsc]b-|-r[rsc]b-"                 # bracket tokens we injected
    r"|'(?:ll|re|ve|s|m|d)(?![^\W_])"      # standalone clitics ('s, 'll, ...)
    r"|\.\.\.+"                            # ellipsis runs
    r"|--+"                                # dash runs
    r"|\d+(?:[.,:]\d+)*(?:[^\W\d_][^\W_]*)?"  # numbers (1,000 / 3.5 / 3d)
    r"|[^\W\d_][^\W_]*(?:[-'][^\W_]+)*"    # words; in-word hyphen/apostrophe
    r"|\S",                                # any other single char
    re.UNICODE)

# PTBLexer contraction handling (VerbStem + n't, clitics, informal forms)
_INFORMAL = {"gonna": ("gon", "na"), "wanna": ("wan", "na"),
             "gotta": ("got", "ta"), "lemme": ("lem", "me"),
             "gimme": ("gim", "me"), "cannot": ("can", "not")}
_CLITICS = ("'ll", "'re", "'ve", "'s", "'m", "'d")


def _split_token(t: str) -> List[str]:
    if t in _INFORMAL:
        return list(_INFORMAL[t])
    if t.endswith("n't") and len(t) > 3:
        return [t[:-3], "n't"]
    for suf in _CLITICS:
        if t.endswith(suf) and len(t) > len(suf):
            return [t[: -len(suf)], suf]
    if len(t) >= 2 and set(t) == {"-"}:
        return ["--"]  # dash runs normalize to PTB's --
    return [t]


def _python_tokenize_line(line: str) -> str:
    s = line
    for ch, rep in _CHAR_MAP.items():
        s = s.replace(ch, rep)
    # double quotes: opening (after start/space/bracket) -> `` else ''
    s = re.sub(r'(^|[\s(\[{])"', r"\1 `` ", s)
    s = s.replace('"', " '' ")
    s = s.lower()
    for ch, rep in _BRACKETS.items():
        s = s.replace(ch, rep)
    tokens: List[str] = []
    for m in _TOKEN.finditer(s):
        tokens.extend(_split_token(m.group()))
    return " ".join(t for t in tokens if t not in PUNCTUATIONS)


def java_available(jar_dir: str = "") -> bool:
    if shutil.which("java") is None:
        return False
    return bool(jar_dir) and os.path.exists(os.path.join(jar_dir, CORENLP_JAR))


class PTBTokenizer:
    def __init__(self, jar_dir: str = ""):
        self.jar_dir = jar_dir
        #: True once tokenize() has used the Python fallback; the evaluator
        #: refuses a parity run (require_ptb_jar) on it.
        self.used_fallback = False

    def tokenize(self, captions_for_image: Dict[object, List[dict]]
                 ) -> Dict[object, List[str]]:
        keys = []
        lines = []
        for k, caps in captions_for_image.items():
            for c in caps:
                keys.append(k)
                lines.append(c["caption"].replace("\n", " "))

        if java_available(self.jar_dir):
            tokenized = self._java_tokenize(lines)
        else:
            self.used_fallback = True
            tokenized = [_python_tokenize_line(line) for line in lines]

        out: Dict[object, List[str]] = {}
        for k, t in zip(keys, tokenized):
            out.setdefault(k, []).append(t)
        return out

    def _java_tokenize(self, lines: List[str]) -> List[str]:
        cmd = ["java", "-cp", os.path.join(self.jar_dir, CORENLP_JAR),
               "edu.stanford.nlp.process.PTBTokenizer",
               "-preserveLines", "-lowerCase"]
        with tempfile.NamedTemporaryFile("w", delete=False,
                                         suffix=".txt") as f:
            f.write("\n".join(lines))
            path = f.name
        try:
            with open(path) as fin:
                res = subprocess.run(cmd, stdin=fin, capture_output=True,
                                     text=True, check=True)
            # keep empty output lines (an empty caption tokenizes to an
            # empty line under -preserveLines); the slice drops only the
            # final newline's phantom element
            out_lines = res.stdout.split("\n")[: len(lines)]
            return [" ".join(w for w in line.split()
                             if w not in PUNCTUATIONS) for line in out_lines]
        finally:
            os.unlink(path)


def tokenize_simple(caps: Dict[object, List[str]]) -> Dict[object, List[str]]:
    """{key: [raw strings]} -> {key: [tokenized strings]}."""
    return {k: [_python_tokenize_line(c) for c in v] for k, v in caps.items()}
