"""METEOR and SPICE through Java subprocesses, used when Java and the jars
are there (the port's own copy of comic_tpu.evaluation.java_metrics).

The reference drives meteor-1.5.jar over a stdin/stdout line protocol and
spice-1.0.jar over temp JSON files (pycocoevalcap/meteor/meteor.py:15-80,
spice/spice.py:16-94). Both stay out of process and are skipped when Java
or a jar is missing; ``available()`` says whether one can run.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List, Optional, Tuple

METEOR_JAR = "meteor-1.5.jar"
SPICE_JAR = "spice-1.0.jar"


def float_convert(obj) -> float:
    """None / non-numeric -> NaN, like the reference's float_convert
    (spice.py:16-21): the SPICE jar writes null for captions its parser
    extracts no tuples from."""
    try:
        return float(obj)
    except (TypeError, ValueError):
        return float("nan")


class MeteorScorer:
    """Line-protocol wrapper: EVAL ||| <stats per segment> -> scores."""

    def __init__(self, jar_dir: str = ""):
        self.jar_dir = jar_dir
        self._proc: Optional[subprocess.Popen] = None
        self._lock = threading.Lock()

    def available(self) -> bool:
        return (shutil.which("java") is not None
                and os.path.exists(os.path.join(self.jar_dir, METEOR_JAR)))

    def _ensure_proc(self):
        if self._proc is None:
            cmd = ["java", "-jar", "-Xmx2G",
                   os.path.join(self.jar_dir, METEOR_JAR),
                   "-", "-", "-stdio", "-l", "en", "-norm"]
            # cwd=None (inherit) for the default jar_dir="": subprocess
            # raises FileNotFoundError on cwd=""
            self._proc = subprocess.Popen(
                cmd, cwd=self.jar_dir or None, stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, text=True, bufsize=1)

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[float]]:
        if not self.available():
            raise RuntimeError("METEOR jar/Java not available")
        with self._lock:
            self._ensure_proc()
            proc = self._proc
            try:
                eval_line = "EVAL"
                for key in gts:
                    # the jar's field separator must not appear in the text
                    # (meteor.py:53-54)
                    hypo = res[key][0].replace("|||", "").replace("  ", " ")
                    refs = [r.replace("|||", "").replace("  ", " ")
                            for r in gts[key]]
                    stat_line = " ||| ".join(
                        ("SCORE", " ||| ".join(refs), hypo))
                    proc.stdin.write(stat_line + "\n")
                    stats = proc.stdout.readline().strip()
                    eval_line += " ||| " + stats
                proc.stdin.write(eval_line + "\n")
                scores = [float(proc.stdout.readline().strip())
                          for _ in gts]
                final = float(proc.stdout.readline().strip())
            except Exception:
                # unread SCORE replies left in the pipe would be read by the
                # next call as its own stats: restart the process instead
                self._close_locked()
                raise
        return final, scores

    def method(self) -> str:
        return "METEOR"

    def _close_locked(self):
        if self._proc is not None:
            try:
                if self._proc.stdin:
                    self._proc.stdin.close()
            except Exception:
                pass
            self._proc.kill()
            self._proc.wait()  # reap: kill() alone leaves a zombie
            self._proc = None

    def close(self):
        with self._lock:
            self._close_locked()

    def __del__(self):
        # as the reference's meteor.py: nothing else makes sure the 2 GB
        # JVM exits when a caller forgets close()
        try:
            self._close_locked()
        except Exception:
            pass


class SpiceScorer:
    """Temp-JSON wrapper around spice-1.0.jar."""

    def __init__(self, jar_dir: str = ""):
        self.jar_dir = jar_dir

    def available(self) -> bool:
        return (shutil.which("java") is not None
                and os.path.exists(os.path.join(self.jar_dir, SPICE_JAR)))

    def _cache_dir(self) -> str:
        """The parse cache lives beside the jar, as the reference's
        (spice.py CACHE_DIR): reference parses are reused across the
        checkpoints of a sweep."""
        base = self.jar_dir or tempfile.gettempdir()
        path = os.path.join(base, "spice_cache")
        os.makedirs(path, exist_ok=True)
        return path

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[dict]]:
        if not self.available():
            raise RuntimeError("SPICE jar/Java not available")
        input_data = [
            {"image_id": str(k), "test": res[k][0], "refs": gts[k]}
            for k in gts
        ]
        with tempfile.TemporaryDirectory() as tmp:
            in_path = os.path.join(tmp, "spice_in.json")
            out_path = os.path.join(tmp, "spice_out.json")
            with open(in_path, "w") as f:
                json.dump(input_data, f)
            cmd = ["java", "-jar", "-Xmx8G",
                   os.path.join(self.jar_dir, SPICE_JAR), in_path,
                   "-cache", self._cache_dir(),
                   "-out", out_path, "-subset", "-silent"]
            subprocess.run(cmd, cwd=self.jar_dir or None, check=True,
                           capture_output=True)
            with open(out_path) as f:
                results = json.load(f)
        by_id = {item["image_id"]: item["scores"] for item in results}
        # null values become NaN, and as in the reference (spice.py:79-91)
        # the NaN propagates into the corpus mean
        scores = [
            {cat: {k: float_convert(v) for k, v in tup.items()}
             for cat, tup in by_id[str(k)].items()}
            for k in gts
        ]
        fs = [s["All"]["f"] for s in scores]
        if not fs:
            return 0.0, scores
        return sum(fs) / len(fs), scores

    def method(self) -> str:
        return "SPICE"
