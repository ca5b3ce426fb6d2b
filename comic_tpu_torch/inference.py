"""Inference: checkpoint sweep -> decode on the card -> metrics.

Counterpart of comic_tpu/inference.py (reference src/infer_fn.py:78-315
run_inference / evaluate_model / evaluate_captions, infer.py:90-138). The
decode runs on the card: uint8 batch -> the encoder's eval preprocessing
-> the encoder (``cnn_name``, Inception-V1 by default) -> beam search (or
greedy); the scoring runs on the host. Artifacts are
the same as comic_tpu's:

  - save dir  ``infer_{set}_beam_{B}_lpen_{L}`` under the experiment dir
  - caption JSON ``captions___{ckpt}.json`` (COCO submission format)
  - ``infer_speed.txt`` captions/sec line per run
  - attention-map pickle ``outputs___{ckpt}.pkl`` (optional)
  - ``metric_scores.{txt,csv}`` and ``metric_scores_detailed_{n}.json``
    through ``evaluation.coco_eval``
"""

from __future__ import annotations

import os
import pickle
import re
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import torch

from . import DeviceLike, resolve_device
from .configuration import Config
from .data.pipeline import InferencePipeline
from .data.preprocessing import preprocess_for
from .decoding import beam_search, greedy_or_sample
from .evaluation.coco_eval import (
    evaluate_captions,
    write_caption_json,
    write_score_artifacts,
)
from .models.captioner import (build_model_spec, init_params,
                               max_decode_steps, tree_to)
from .parallel.mesh import (Mesh, available_devices, make_mesh_for_batch,
                            process_count, shard_batch, start_host_fetch)
from .tokenization import Vocabulary, ids_to_captions
from .training import checkpoints as ckpt

pjoin = os.path.join


def image_id_from_path(filepath: str):
    """Reference id rules (infer_fn.py:140-148): a name containing '@'
    (insta) keeps its STRING stem; otherwise the first '_'-prefixed digit
    run of the basename is the int COCO id; a name with neither gives the
    string stem."""
    stem = os.path.splitext(os.path.basename(filepath))[0]
    if "@" in stem:
        return stem
    m = re.search(r"(?<=_)\d+", stem)
    return int(m.group(0)) if m else stem


def infer_dir_name(config: Config) -> str:
    lpen = config.infer_length_penalty_weight or 0.0
    return (f"infer_{config.infer_set}_beam_{config.infer_beam_size}"
            f"_lpen_{lpen}")


def _ckpt_name(ckpt_path: str) -> str:
    """Suffixless checkpoint name for artifact keys."""
    name = os.path.basename(ckpt_path.rstrip(os.sep))
    for suffix in (ckpt._SUFFIX, ckpt._ORBAX_SUFFIX, ckpt._TF_SUFFIX):
        if name.endswith(suffix):
            name = name[: -len(suffix)]
    return name


def _refuse_multiprocess() -> None:
    """Serving is one process per host, whose mesh is the cards it drives;
    refuse inside a multi-process torch.distributed job, as comic_tpu
    does: each rank would caption and write the whole set. Runs before
    the mesh, the checkpoint or the pipeline is made."""
    if process_count() > 1:
        raise NotImplementedError(
            "serving under a multi-process torch.distributed job is not "
            "supported — launch inference as a single-process job per "
            "host.")


def make_serve_fn(spec, config: Config, steps: int,
                  collect_alignments: bool = True,
                  device: DeviceLike = None, mesh: Optional[Mesh] = None):
    """The serving fn (params, images_u8) -> (ids (B, T) int32 on the
    device, alignments (B, H, T, L) or None), for ``device`` (None: the
    card).

    Beam search when ``infer_beam_size`` > 1 (its attention step is the
    grouped kernel K1 on the card), greedy otherwise (kernel K2).

    With a ``mesh`` (one process's cards) each card takes a contiguous
    block of the batch with its own copy of the parameters (made once
    per parameter tree), and the outputs come back concatenated in block
    order on the mesh's first card. The first block runs on this thread
    and each other block on a thread of its own, so the cards' decode
    loops (their launches and early-exit syncs) overlap. Early exit is per
    block and gives the same ids as the whole batch's loop.
    """
    device = resolve_device(device)
    h, w = config.cnn_input_size
    beam = int(config.infer_beam_size)
    lpen = float(config.infer_length_penalty_weight or 0.0)
    preprocess = preprocess_for(config.cnn_name)
    early = bool(config.get("infer_early_exit"))

    @torch.inference_mode()
    def serve_block(params, images_u8, device):
        images = preprocess(images_u8, h, w, device)
        if beam > 1:
            top, _ = beam_search(params, spec, images, beam_size=beam,
                                 max_steps=steps, length_penalty=lpen,
                                 collect_alignments=collect_alignments,
                                 early_exit=early)
        else:
            top = greedy_or_sample(params, spec, images, max_steps=steps,
                                   collect_alignments=collect_alignments,
                                   early_exit=early)
        if not collect_alignments:
            return top.ids, None
        return top.ids, top.alignments

    if mesh is None:
        return lambda params, images_u8: serve_block(params, images_u8,
                                                     device)
    _refuse_multiprocess()  # defense in depth for direct callers
    copies = {}  # the parameters on each card, for the last tree served

    def serve(params, images_u8):
        if copies.get("of") is not params:
            copies.clear()
            copies["of"] = params
            copies.update({d: tree_to(params, d) for d in set(mesh.devices)})
        (d0, x0), *others = zip(mesh.devices, shard_batch(mesh, images_u8))
        with ThreadPoolExecutor(max(len(others), 1)) as pool:
            rest = [pool.submit(serve_block, copies[d], x, d)
                    for d, x in others]
            outs = [serve_block(copies[d0], x0, d0)]
            outs += [f.result() for f in rest]
        first = mesh.devices[0]
        ids = torch.cat([o[0].to(first) for o in outs])
        if not collect_alignments:
            return ids, None
        return ids, torch.cat([o[1].to(first) for o in outs])

    return serve


def _serve_mesh(config: Config, device: DeviceLike) -> Mesh:
    """The cards a serve fn of ``device`` spreads its batch over: of the
    cards ``device`` names (parallel.available_devices), the most that
    divide batch_size_infer, capped by num_data_shards (the CPU: one
    block)."""
    return make_mesh_for_batch(
        config.batch_size_infer,
        limit=int(config.get("num_data_shards") or 0),
        devices=available_devices(device))


def run_inference(config: Config, ckpt_path: str,
                  save_attention: bool = False, serve=None, pipe=None,
                  device: DeviceLike = None) -> Tuple[str, str]:
    """Caption the configured infer set with one compact checkpoint on
    ``device`` (None: the card). ``serve``/``pipe`` may be passed in to
    reuse them across checkpoints; a passed pipe stays open.

    Returns (save_dir, caption_json_path).
    """
    _refuse_multiprocess()  # before the checkpoint or the pipeline
    device = resolve_device(device)
    vocab = Vocabulary.from_str_itow(config.wtoi, config.itow)
    spec = build_model_spec(config, vocab)
    params = ckpt.load_compact(ckpt_path, init_params(spec, device=device))

    own_pipe = pipe is None
    if own_pipe:
        pipe = InferencePipeline(config)
    try:
        steps = max_decode_steps(config, vocab)
        if serve is None:
            serve = make_serve_fn(spec, config, steps,
                                  collect_alignments=save_attention,
                                  device=device,
                                  mesh=_serve_mesh(config, device))
        ckpt_name = _ckpt_name(ckpt_path)
        save_dir = pjoin(config.log_path, infer_dir_name(config))
        os.makedirs(save_dir, exist_ok=True)

        limit = config.get("infer_attention_max_images")
        limit = 4 if limit is None else int(limit)  # 0 = maps for none, -1 all
        all_ids: List = []
        all_caps: List[str] = []
        # reference raw-outputs pickle (infer_fn.py:107-151): three
        # filename-keyed dicts, 'attention' capped at `limit` images
        raw_outputs: Dict = {"captions": {}, "attention": {}, "image_ids": {}}

        def wants_maps() -> bool:
            return limit < 0 or len(raw_outputs["attention"]) < limit

        def consume(ids, attn, files):
            caps = ids_to_captions(ids.numpy(), config.token_type, vocab,
                                   config.radix_base)
            for f, c in zip(files, caps):
                all_ids.append(image_id_from_path(f))
                all_caps.append(c)
            if save_attention:
                maps = attn.numpy() if attn is not None else None
                for j, (f, c) in enumerate(zip(files, caps)):
                    raw_outputs["captions"][f] = c
                    raw_outputs["image_ids"][f] = image_id_from_path(f)
                    if maps is not None and wants_maps():
                        raw_outputs["attention"][f] = maps[j]
            return len(caps)

        n_done = 0
        t0 = time.time()
        pending = None  # batch i is consumed while batch i+1 decodes
        for images, files in iter(pipe):
            ids, attn = serve(params, images)
            if save_attention and attn is None:
                raise ValueError(
                    "save_attention=True but the serve fn returned no "
                    "alignment maps — it was built with "
                    "collect_alignments=False.")
            ids, = start_host_fetch(ids)
            if pending is not None:
                n_done += consume(*pending)
            # maps are big ((B, H, T, L) f32): copy them only while wanted
            attn = (start_host_fetch(attn)[0]
                    if save_attention and wants_maps() else None)
            pending = (ids, attn, files)
        if pending is not None:
            n_done += consume(*pending)
        dt = time.time() - t0

        if len(set(map(str, all_ids))) != len(all_ids):
            raise AssertionError("Duplicate image ids in inference output.")

        json_path = pjoin(save_dir, f"captions___{ckpt_name}.json")
        write_caption_json(json_path, all_ids, all_caps)
        with open(pjoin(save_dir, "infer_speed.txt"), "a") as f:
            f.write(f"{ckpt_name}: {n_done / max(dt, 1e-9):.2f} captions/sec "
                    f"({n_done} images in {dt:.1f}s)\n")
        if save_attention and raw_outputs["captions"]:
            with open(pjoin(save_dir, f"outputs___{ckpt_name}.pkl"),
                      "wb") as f:
                pickle.dump(raw_outputs, f, pickle.HIGHEST_PROTOCOL)
    finally:
        if own_pipe:
            pipe.close()
    return save_dir, json_path


def evaluate_model(config: Config, ckpt_path: str,
                   annotations_file: Optional[str] = None,
                   jar_dir: str = "", serve=None, pipe=None,
                   run_infer: bool = True, get_metric_score: bool = True,
                   save_attention: bool = False,
                   require_ptb_jar: bool = False,
                   device: DeviceLike = None) -> Optional[Dict[str, float]]:
    """run_inference on ``device`` (None: the card), then metric scoring
    and artifacts on the host (infer_fn.py:188-292).

    An existing caption JSON is reused. The reference's ``run_inference``
    / ``get_metric_score`` toggles (infer.py:46-50) select which halves
    run. Returns the scores (None when scoring is off or there is no
    annotation file)."""
    ckpt_name = _ckpt_name(ckpt_path)
    save_dir = pjoin(config.log_path, infer_dir_name(config))
    json_path = pjoin(save_dir, f"captions___{ckpt_name}.json")
    if not os.path.exists(json_path):
        if not run_infer:
            print(f"WARNING: no caption JSON for {ckpt_name} and "
                  "run_inference=False; skipping.")
            return None
        _, json_path = run_inference(config, ckpt_path,
                                     save_attention=save_attention,
                                     serve=serve, pipe=pipe, device=device)

    if not get_metric_score:
        return None
    if annotations_file is None:
        annotations_file = config.get("annotations_file")
    if not annotations_file or not os.path.exists(annotations_file):
        print("WARNING: no annotation file; skipping metric scoring.")
        return None
    scores, img_to_eval = evaluate_captions(annotations_file, json_path,
                                            jar_dir,
                                            require_ptb_jar=require_ptb_jar)
    write_score_artifacts(save_dir, ckpt_name, scores, img_to_eval)
    return scores


def sweep_checkpoints(config: Config,
                      annotations_file: Optional[str] = None,
                      jar_dir: str = "",
                      checkpoints: str = "all",
                      run_infer: bool = True,
                      get_metric_score: bool = True,
                      save_attention: bool = False,
                      require_ptb_jar: bool = False,
                      device: DeviceLike = None
                      ) -> Dict[str, Dict[str, float]]:
    """Evaluate the reference's checkpoint selection on ``device`` (None:
    the card; only used when ``run_infer``): every compact checkpoint (the
    last 12 when more than 20 exist, infer.py:90-97), or a comma-separated
    list of checkpoint numbers (``--infer_checkpoints``,
    infer.py:37-38,99-102). One serve fn and one pipeline serve every
    checkpoint."""
    if run_infer:
        _refuse_multiprocess()  # before any checkpoint or pipeline work
    if checkpoints and checkpoints != "all":
        nums = [s for s in str(checkpoints).split(",") if s]
        if not nums:
            raise ValueError("`infer_checkpoints` must be 'all' or a "
                             "comma-separated list of checkpoint numbers.")
        names = [ckpt.COMPACT_PREFIX + n for n in nums]
    else:
        names = ckpt.select_eval_checkpoints(config.log_path)
    if not names:
        raise FileNotFoundError(
            f"No compact checkpoints under {config.log_path}")

    serve = pipe = None
    if run_infer:
        vocab = Vocabulary.from_str_itow(config.wtoi, config.itow)
        spec = build_model_spec(config, vocab)
        serve = make_serve_fn(spec, config, max_decode_steps(config, vocab),
                              collect_alignments=save_attention,
                              device=device,
                              mesh=_serve_mesh(config, device))
        pipe = InferencePipeline(config)
    results = {}
    try:
        for name in names:
            # suffixless: load_compact resolves the file on disk
            path = pjoin(config.log_path, name)
            json_done = os.path.exists(
                pjoin(config.log_path, infer_dir_name(config),
                      f"captions___{name}.json"))
            if run_infer and not json_done:
                try:
                    # a pruned or mistyped checkpoint number must not throw
                    # away the checkpoints already evaluated; only the
                    # checkpoint's resolution is forgiven, errors of the
                    # dataset or the annotations propagate
                    ckpt._resolve(path, ckpt.COMPACT_PREFIX)
                except FileNotFoundError as e:
                    print(f"WARNING: skipping {name}: {e}")
                    continue
            scores = evaluate_model(config, path, annotations_file,
                                    jar_dir, serve=serve, pipe=pipe,
                                    run_infer=run_infer,
                                    get_metric_score=get_metric_score,
                                    save_attention=save_attention,
                                    require_ptb_jar=require_ptb_jar,
                                    device=device)
            if scores is not None:
                results[name] = scores
    finally:
        if pipe is not None:
            pipe.close()
    return results
