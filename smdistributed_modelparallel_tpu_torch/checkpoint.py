"""Checkpoint save, load and resume of the PyTorch port.

Counterpart of ``smdistributed_modelparallel_tpu/checkpoint.py``, writing and
reading the same on-disk format, so that a run moves between the two
packages in either direction:

- ``smp.save`` / ``smp.load``: pickled objects, per-rank files named
  ``{f}_{pp}_{tp}_{rdp}`` (``v3``) or ``{f}_{pp}_{tp}`` (v2), the name
  detected on load;
- ``save_checkpoint(partial=True)``: a ``{tag}_partial/`` directory holding
  ``model_shards_p{rank}.npz`` and ``optimizer_shards_p{rank}.npz`` (the
  ``shard_io`` catalogs, in the JAX package's keys: the model's
  ``reference_state_dict`` and the optimizer's optax layout),
  ``fp16_states.pt`` and ``quant_states.pt`` (per rank coordinates),
  ``user_content.pt`` and ``smp_config.pt`` (the config, the writer census
  ``num_processes`` and ``step_count``); at tp > 1 each tp rank writes its
  region of every tp-sharded leaf (``DistributedModel.tp_pieces``) and tp
  rank 0 the replicated ones, committed by the ``.inflight_s{seq}``
  / ``.done_p{rank}`` / ``.committed`` protocol before the ``newest`` pointer
  moves; ``num_kept_partial_checkpoints`` keeps the newest committed
  directories and sweeps interrupted ones;
- ``save_checkpoint(partial=False)``: one pickle ``{path}/{tag}`` whose
  ``model`` and ``optimizer`` entries are the same reference-keyed dicts
  (gathered whole over tp), so the JAX package loads them; under ``translate_if_full`` (the default) the
  ``model`` dict goes through the model's ``to_hf`` translator where it has
  one (``smp.from_hf`` gives it the family's, which emits the source's HF
  names; else the tp registry's entry for the module's class): a dict the HF
  class loads. A translator that raises is logged and the dict saved as it
  is, as the JAX package does;
- ``blocking=False``: the tensors are copied to the host before the call
  returns (torch updates parameters and moments in place, so a copy still in
  flight at the next ``optimizer.step()`` would save half-updated weights);
  serialization and IO run on one background thread in submission order;
  ``wait_for_checkpoints`` drains it and raises the first failure;
- ``resume_from_checkpoint``: refuses an interrupted save, checks the shard
  files' coverage and census before anything is applied, restores the loss
  scaler, the fp8 state and ``step_count``, and applies the model and
  optimizer state now or, when they do not exist yet, when they are built.
  A checkpoint saved under another degree layout resumes with ``elastic=True``
  (``resilience/elastic.py``): each leaf is reassembled whole from its pieces.

Ranks are ``torch.distributed`` ranks (``backend/state.py``). A blocking save
and a resume are attributed ``ckpt_save`` / ``ckpt_restore`` by the goodput
ledger (``utils/goodput.py``), as in the JAX package; the executable cache's
warm-start note waits for the executable cache (the AOT store). Unlike the JAX package, whose recovery
supervisor restores the step edge, ``resume_from_checkpoint`` sets
``state.step_count`` from the checkpoint itself. The JAX package's elastic
resume consults ``supervisor._recovering`` only to leave that warm-start
note to a recovery; with no executable cache the port has nothing to count
there, at a recovery or not.
"""

import glob
import os
import pickle
import shutil
import time

from smdistributed_modelparallel_tpu_torch.backend.state import state
from smdistributed_modelparallel_tpu_torch.utils.exceptions import SMPRuntimeError, SMPValidationError
from smdistributed_modelparallel_tpu_torch.utils.goodput import goodput
from smdistributed_modelparallel_tpu_torch.utils.logger import get_logger

logger = get_logger()

# Save ordinals restart at 0 in every process, but marker files survive on
# disk: a marker older than this process is debris of an earlier run and
# can neither outrank a fresh save nor satisfy a fresh commit's wait. 2 s of
# slack absorbs coarse filesystem timestamps.
_RUN_START = time.time() - 2.0


def _fresh(path_):
    """True when ``path_`` was written by this process."""
    try:
        return os.path.getmtime(path_) >= _RUN_START
    except OSError:
        return False


def _coords():
    """This rank's (pp, tp, rdp) coordinates."""
    if state.topology is None:
        return 0, 0, 0
    c = state.topology.coords(state.rank)
    return c.get("pp", 0), c.get("tp", 0), c.get("rdp", 0)


def _degrees():
    t = state.topology
    return (1, 1, 1) if t is None else (t.pp_size, t.tp_size, t.rdp_size)


def _process_index():
    return state.rank


def _process_count():
    return state.world_size


def _partial_name(f, v3=True):
    pp, tp, rdp = _coords()
    stem, ext = os.path.splitext(f)
    if v3:
        return f"{stem}_{pp}_{tp}_{rdp}{ext}"
    return f"{stem}_{pp}_{tp}{ext}"


def save(obj, f, partial=True, v3=True):
    """Pickle ``obj`` to ``f`` (this rank's ``_{pp}_{tp}_{rdp}`` file when
    ``partial``). Returns the path written."""
    path = _partial_name(f, v3) if partial else f
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fh:
        pickle.dump(obj, fh, protocol=4)
    return path


def load(f, partial=True):
    """Unpickle ``f``, trying this rank's v3 name ``_{pp}_{tp}_{rdp}``, then
    the v2 name ``_{pp}_{tp}``, then the bare (full) name."""
    candidates = [f]
    if partial:
        candidates = [_partial_name(f, v3=True), _partial_name(f, v3=False), f]
    for path in candidates:
        if os.path.exists(path):
            with open(path, "rb") as fh:
                return pickle.load(fh)
    raise SMPRuntimeError(f"Checkpoint not found: tried {candidates}")


# ----------------------------------------------------------------------
# Directory checkpoints
# ----------------------------------------------------------------------


def _smp_config_snapshot():
    cfg = state.cfg
    if cfg is None:
        return {}
    snapshot = dict(cfg.as_dict())
    # Writer census: the one completeness check that sees a missing tail
    # shard file (ShardCatalog.verify_complete).
    snapshot["num_processes"] = _process_count()
    # The step edge this checkpoint represents.
    snapshot["step_count"] = state.step_count
    return snapshot


def verify_smp_config(saved):
    """Raise ``SMPValidationError`` when the saved parallelism layout is
    incompatible with the live config: the degrees and the flags that
    decide where state lives must match to reuse a partial checkpoint."""
    cfg = state.cfg
    if cfg is None:
        raise SMPValidationError("smp.init must run before resume_from_checkpoint.")
    keys = (
        "pipeline_parallel_degree",
        "tensor_parallel_degree",
        "microbatches",
        "optimize",
        "prescaled_batch",
        "shard_optimizer_state",
        "sharded_data_parallel_degree",
        "sharded_params",
    )
    mismatches = {
        k: (saved.get(k), getattr(cfg, k))
        for k in keys
        if k in saved and saved.get(k) != getattr(cfg, k)
    }
    if mismatches:
        raise SMPValidationError(
            "Saved checkpoint smp config is incompatible with the current "
            f"config: {mismatches}"
        )


def save_checkpoint(path, tag=None, model=None, optimizer=None,
                    user_content=None, partial=True,
                    num_kept_partial_checkpoints=None, translate_if_full=True,
                    blocking=True):
    """Write a checkpoint under ``path``: ``{tag}_partial/`` with this
    rank's shard files (``partial=True``) or the gathered pickle ``{tag}``
    (``partial=False``); then move the ``newest`` pointer and, with
    ``num_kept_partial_checkpoints``, drop older partial checkpoints.
    ``model``/``optimizer`` default to the current ones, ``tag`` to
    ``step_{step_count}``. ``blocking=False`` returns once every tensor is
    copied to the host and ``user_content`` deep-copied; the rest runs on a
    background thread (``wait_for_checkpoints``)."""
    if state.topology is not None and state.topology.pp_size > 1:
        raise NotImplementedError(
            "smp.save_checkpoint: pipeline_parallel_degree > 1 (partial saves per stage, full gathers) is not "
            "ported to PyTorch yet (ROADMAP item 8)."
        )
    if state.topology is not None and state.topology.ep_size > 1:
        raise NotImplementedError(
            "smp.save_checkpoint: expert_parallel_degree > 1 (each ep rank holds a slice of the experts, sharded "
            "state) is not ported to PyTorch yet (ROADMAP item 9)."
        )
    model = model if model is not None else state.model
    optimizer = optimizer if optimizer is not None else state.optimizer
    tag = tag if tag is not None else f"step_{state.step_count}"
    os.makedirs(path, exist_ok=True)
    # Commit ordinal: ranks save in the same order, so this per-process
    # counter agrees across ranks and tells this save's markers from an
    # earlier save of the same tag. Taken at submission.
    global _SAVE_SEQ
    _SAVE_SEQ += 1
    seq = _SAVE_SEQ

    # Snapshot everything now; the job below touches only captured values.
    user_content = pickle.loads(pickle.dumps(user_content, protocol=4))
    with_opt = optimizer is not None and optimizer.has_state
    if partial:
        from smdistributed_modelparallel_tpu_torch.shard_io import shard_payload

        # At tp > 1 the reference dicts are gathered whole (a collective over
        # tp); each tp rank writes its region of the sharded leaves.
        pieces = model.tp_pieces() if model is not None and model._tp_specs else None
        model_payload = shard_payload(model.reference_state_dict(), tp_pieces=pieces) if model is not None else None
        opt_pieces = {f"0/{m}/{k}": b for k, b in pieces.items() for m in ("mu", "nu")} if pieces else None
        opt_payload = shard_payload(optimizer.reference_state_dict(), tp_pieces=opt_pieces) if with_opt else None
        scaler_sd = state.loss_scaler.state_dict() if state.loss_scaler is not None else None
        quant_sd = state.quant_state.state_dict() if state.quant_state is not None else None
        cfg_snapshot = _smp_config_snapshot()
        live_degrees = _degrees()
        me, world = _process_index(), _process_count()

        def job():
            import numpy as np

            ckpt_dir = os.path.join(path, f"{tag}_partial")
            os.makedirs(ckpt_dir, exist_ok=True)
            # In-flight marker before the first shard write: the positive
            # evidence of an interrupted save that the GC orphan sweep and
            # resume's refusal need. The ordinal is in the name, so a
            # concurrent commit of save N never mistakes save N+1's stamp.
            _write_atomic(os.path.join(ckpt_dir, f".inflight_s{seq}"), str(seq))
            # A re-save of a committed tag overwrites its files in place:
            # drop the stale .committed so a crash mid-overwrite reads as an
            # interrupted save.
            try:
                os.unlink(os.path.join(ckpt_dir, ".committed"))
            except OSError:
                pass
            if me == 0:
                # A re-save from a smaller world leaves the old world's
                # higher-indexed shard files; no live rank writes them.
                for fname in os.listdir(ckpt_dir):
                    for comp in ("model_shards_p", "optimizer_shards_p"):
                        if fname.startswith(comp) and fname.endswith(".npz"):
                            try:
                                idx = int(fname[len(comp):-4])
                            except ValueError:
                                continue
                            if idx >= world:
                                try:
                                    os.unlink(os.path.join(ckpt_dir, fname))
                                except OSError:
                                    pass
                # Per-coordinate side files outside the live degrees (or all
                # of them when this save carries none) are stale too.
                for prefix, present in (("fp16_states_", scaler_sd is not None),
                                        ("quant_states_", quant_sd is not None)):
                    for fname in os.listdir(ckpt_dir):
                        if not (fname.startswith(prefix) and fname.endswith(".pt")):
                            continue
                        parts = fname[len(prefix):-3].split("_")
                        try:
                            coords = [int(p) for p in parts]
                        except ValueError:
                            continue
                        stale = not present or len(coords) != 3 or any(
                            c >= d for c, d in zip(coords, live_degrees)
                        )
                        if stale:
                            try:
                                os.unlink(os.path.join(ckpt_dir, fname))
                            except OSError:
                                pass
            if model_payload is not None:
                np.savez(os.path.join(ckpt_dir, f"model_shards_p{me}.npz"), **model_payload)
            if opt_payload is not None:
                np.savez(os.path.join(ckpt_dir, f"optimizer_shards_p{me}.npz"), **opt_payload)
            if scaler_sd is not None:
                save(scaler_sd, os.path.join(ckpt_dir, "fp16_states.pt"))
            if quant_sd is not None:
                save(quant_sd, os.path.join(ckpt_dir, "quant_states.pt"))
            with open(os.path.join(ckpt_dir, "user_content.pt"), "wb") as fh:
                pickle.dump(user_content, fh, protocol=4)
            with open(os.path.join(ckpt_dir, "smp_config.pt"), "wb") as fh:
                pickle.dump(cfg_snapshot, fh, protocol=4)
            _commit_checkpoint(path, ckpt_dir, tag, num_kept_partial_checkpoints, seq, me, world)
    else:
        sd = model.reference_state_dict() if model is not None else {}
        if translate_if_full:
            sd = _maybe_translate_to_hf(model, sd)
        payload = {
            "model": sd,
            "user_content": user_content,
            "smp_config": _smp_config_snapshot(),
        }
        if with_opt:
            payload["optimizer"] = optimizer.reference_state_dict()

        def job():
            with open(os.path.join(path, tag), "wb") as fh:
                pickle.dump(payload, fh, protocol=4)
            _finish_checkpoint(path, tag, partial, num_kept_partial_checkpoints)

    if blocking:
        # The calling thread waits for the whole serialize+IO+commit:
        # badput, attributed ckpt_save by the goodput ledger. The async
        # path records nothing: its work overlaps training.
        with goodput.scope("ckpt_save"):
            if _SAVER is not None:
                # Behind any in-flight async saves: running inline would race
                # the writer thread on `newest` and retention GC.
                _saver_executor().submit(job).result()
            else:
                job()
    else:
        _PENDING_SAVES.append(_saver_executor().submit(job))


_SAVE_SEQ = 0


def _maybe_translate_to_hf(model, sd):
    """``sd`` through the model's ``to_hf`` translator (its own
    ``translate_functions``, else the tp registry's for its module's class),
    or as it is when it has none or the translator raises."""
    if model is None:
        return sd
    fns = getattr(model, "_translate_functions", None)
    if fns is None and state.tp_registry is not None:
        fns = state.tp_registry.translate_functions(type(model.module))
    if fns is None:
        return sd
    to_hf = fns[0] if isinstance(fns, (tuple, list)) else fns
    try:
        return to_hf(sd)
    except Exception:  # a user translator: log it and keep the untranslated dict
        logger.warning("HF state-dict translation failed; saving the untranslated dict.", exc_info=True)
        return sd


def _commit_timeout():
    """Commit rendezvous wait bound (``SMP_CKPT_COMMIT_TIMEOUT``, seconds),
    read per call."""
    return float(os.environ.get("SMP_CKPT_COMMIT_TIMEOUT", "600"))


def _write_atomic(path, text):
    # pid-qualified tmp name: several ranks write some of these paths
    # concurrently into a shared directory.
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as fh:
        fh.write(text)
    os.replace(tmp, path)


def _inflight_seqs(ckpt_dir):
    """Map of in-flight marker filename -> save ordinal for ``ckpt_dir``
    (``.inflight_s{seq}``; a literal ``.inflight`` counts with its numeric
    content, or 0)."""
    out = {}
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return out
    for n in names:
        if n.startswith(".inflight_s"):
            try:
                out[n] = int(n[len(".inflight_s"):])
            except ValueError:
                out[n] = 0
        elif n == ".inflight":
            try:
                with open(os.path.join(ckpt_dir, n)) as fh:
                    out[n] = int(fh.read().strip() or 0)
            except (OSError, ValueError):
                out[n] = 0
    return out


def _commit_checkpoint(path, ckpt_dir, tag, num_kept, seq, me, world):
    """One commit for a multi-rank partial save: every rank writes
    ``.done_p{rank}`` with the save ordinal once its files are on disk;
    rank 0 alone waits for every peer's marker to reach this ordinal, then
    publishes ``.committed`` and ``newest`` and runs retention GC."""
    if world > 1:
        _write_atomic(os.path.join(ckpt_dir, f".done_p{me}"), str(seq))
        if me != 0:
            logger.info("Wrote partial checkpoint shards for '%s' (p%d).", tag, me)
            return
        timeout = _commit_timeout()
        deadline = time.monotonic() + timeout
        for p in range(1, world):
            marker = os.path.join(ckpt_dir, f".done_p{p}")
            while True:
                try:
                    with open(marker) as fh:
                        if int(fh.read().strip() or 0) >= seq and _fresh(marker):
                            break
                except (FileNotFoundError, ValueError):
                    pass
                if time.monotonic() > deadline:
                    raise SMPRuntimeError(
                        f"checkpoint commit timed out waiting for process "
                        f"{p}'s shards under {ckpt_dir} (> {timeout}s)."
                    )
                time.sleep(0.05)
    _finish_checkpoint(path, tag, True, num_kept, seq=seq)


def _finish_checkpoint(path, tag, partial, num_kept, seq=None):
    if partial:
        # .committed inside the directory before `newest` moves, unless a
        # newer save of the same tag has already stamped its in-flight
        # marker (it is overwriting the files in place); the re-check after
        # the write covers a stamp landing in between.
        ckpt_dir = os.path.join(path, f"{tag}_partial")
        my_seq = float("inf") if seq is None else seq

        def newer_live(stamps):
            return any(s > my_seq and _fresh(os.path.join(ckpt_dir, n)) for n, s in stamps.items())

        marker = os.path.join(ckpt_dir, ".committed")
        if not newer_live(_inflight_seqs(ckpt_dir)):
            _write_atomic(marker, tag)
            stamps = _inflight_seqs(ckpt_dir)
            if newer_live(stamps):
                try:
                    os.unlink(marker)
                except OSError:
                    pass
            else:
                for name in stamps:
                    try:
                        os.unlink(os.path.join(ckpt_dir, name))
                    except OSError:
                        pass
    _write_atomic(os.path.join(path, "newest"), tag)
    logger.info("Saved %s checkpoint '%s' under %s.", "partial" if partial else "full", tag, path)
    if partial and num_kept is not None:
        _gc_partial_checkpoints(path, num_kept)


_SAVER = None
_PENDING_SAVES = []


def _saver_executor():
    global _SAVER
    if _SAVER is None:
        import atexit
        from concurrent.futures import ThreadPoolExecutor

        # One worker: saves run in submission order, so `newest` ends at
        # the latest submitted tag.
        _SAVER = ThreadPoolExecutor(max_workers=1, thread_name_prefix="smp-ckpt")
        atexit.register(wait_for_checkpoints)
    return _SAVER


def wait_for_checkpoints():
    """Drain pending non-blocking saves; re-raise the first failure.
    Registered at exit, so fire-and-forget saves still complete."""
    global _PENDING_SAVES
    pending, _PENDING_SAVES = _PENDING_SAVES, []
    first_err = None
    for fut in pending:
        try:
            fut.result()
        except Exception as e:  # noqa: BLE001 - surfaced to the caller
            logger.error("async checkpoint save failed: %s", e)
            if first_err is None:
                first_err = e
    if first_err is not None:
        raise first_err


def _gc_partial_checkpoints(path, keep):
    """Keep the ``keep`` newest committed ``{tag}_partial/`` directories.
    A directory with an in-flight stamp and no ``.committed`` older than the
    commit timeout is an interrupted save and is swept; one with neither
    marker predates the protocol and counts as committed."""
    if keep <= 0:
        return
    dirs = [d for d in os.listdir(path) if d.endswith("_partial") and os.path.isdir(os.path.join(path, d))]
    committed, orphans = [], []
    now = time.time()
    stale_after = _commit_timeout()
    for d in dirs:
        full = os.path.join(path, d)
        if os.path.exists(os.path.join(full, ".committed")) or not _inflight_seqs(full):
            committed.append(d)
            continue
        try:
            age = now - os.path.getmtime(full)
        except OSError:
            continue  # swept by a concurrent GC
        if age > stale_after:
            orphans.append(d)
    for d in orphans:
        shutil.rmtree(os.path.join(path, d), ignore_errors=True)
        logger.warning("Swept orphaned (uncommitted, > %.0fs old) checkpoint dir %s — "
                       "debris of an interrupted save.", stale_after, d)
    committed.sort(key=lambda d: os.path.getmtime(os.path.join(path, d)))
    for d in committed[:-keep]:
        shutil.rmtree(os.path.join(path, d), ignore_errors=True)
        logger.info("Removed old partial checkpoint %s.", d)


def resume_from_checkpoint(path, tag=None, partial=True, strict=True,
                           load_optimizer=True, load_sharded_optimizer_state=True,
                           elastic=True):
    """Load the checkpoint ``tag`` (default: ``newest``) under ``path`` and
    return its ``user_content``. The model and optimizer state is applied
    now, or stashed until the model / optimizer is built. A saved layout
    that differs from the live config resumes with ``elastic=True`` and
    raises ``SMPValidationError`` with ``elastic=False``."""
    # The restore blocks training end to end: badput (ckpt_restore) in the
    # goodput ledger. One attribute test while disarmed.
    with goodput.scope("ckpt_restore"):
        return _resume_from_checkpoint(path, tag, partial, strict, load_optimizer, elastic)


def _resume_from_checkpoint(path, tag, partial, strict, load_optimizer, elastic):
    if state.topology is not None and state.topology.pp_size > 1:
        raise NotImplementedError(
            "smp.resume_from_checkpoint: pipeline_parallel_degree > 1 (stage checkpoints, elastic pp 1 <-> 2) is "
            "not ported to PyTorch yet (ROADMAP item 8)."
        )
    if tag is None:
        newest = os.path.join(path, "newest")
        if not os.path.exists(newest):
            raise SMPRuntimeError(f"No 'newest' pointer file under {path}.")
        with open(newest) as fh:
            tag = fh.read().strip()

    def _verify(saved_cfg, shard_format, what):
        try:
            verify_smp_config(saved_cfg)
        except SMPValidationError:
            # Elastic downgrades topology mismatches only; resuming before
            # smp.init stays an error either way.
            if not elastic or state.cfg is None:
                raise
            from smdistributed_modelparallel_tpu_torch.resilience.elastic import begin_elastic_resume

            begin_elastic_resume(saved_cfg, _smp_config_snapshot(), shard_format, what=what)

    if partial:
        from smdistributed_modelparallel_tpu_torch.shard_io import ShardCatalog

        ckpt_dir = os.path.join(path, f"{tag}_partial")
        if not os.path.isdir(ckpt_dir):
            raise SMPRuntimeError(f"Partial checkpoint dir not found: {ckpt_dir}")
        if not os.path.exists(os.path.join(ckpt_dir, ".committed")) and _inflight_seqs(ckpt_dir):
            # The shard files may be half-overwritten, and every per-file
            # check would still pass: refuse.
            raise SMPRuntimeError(
                f"Checkpoint '{tag}' under {path} was interrupted mid-save "
                "(in-flight markers present, no commit marker): its shard "
                "files may be half-written. Resume an older committed tag, "
                "or remove the in-flight markers only if you are certain "
                "every rank's save completed."
            )
        with open(os.path.join(ckpt_dir, "smp_config.pt"), "rb") as fh:
            saved_cfg = pickle.load(fh)
        shard_format = bool(glob.glob(os.path.join(ckpt_dir, "model_shards_p*.npz")))
        _verify(saved_cfg, shard_format, what=f"of '{tag}'")
        if shard_format:
            model_sd = ShardCatalog(ckpt_dir, "model")
            # Gaps and a missing peer file fail here, not at the deferred
            # apply.
            model_sd.verify_complete(what=f"model checkpoint '{tag}'",
                                     expected_files=saved_cfg.get("num_processes"))
        else:  # legacy gathered-pickle layout
            model_sd = load(os.path.join(ckpt_dir, "model.pt"))
        opt_sd = None
        if load_optimizer:
            if glob.glob(os.path.join(ckpt_dir, "optimizer_shards_p*.npz")):
                opt_sd = ShardCatalog(ckpt_dir, "optimizer")
                opt_sd.verify_complete(what=f"optimizer checkpoint '{tag}'",
                                       expected_files=saved_cfg.get("num_processes"))
            else:
                try:
                    opt_sd = load(os.path.join(ckpt_dir, "optimizer.pt"))
                except SMPRuntimeError:
                    opt_sd = None
        if state.loss_scaler is not None:
            scaler_sd = _load_side_file(os.path.join(ckpt_dir, "fp16_states.pt"))
            if scaler_sd is not None:
                state.loss_scaler.load_state_dict(scaler_sd)
        qs = _live_quant_state()
        if qs is not None:
            quant_sd = _load_side_file(os.path.join(ckpt_dir, "quant_states.pt"))
            if quant_sd is not None:
                qs.load_state_dict(quant_sd)
        with open(os.path.join(ckpt_dir, "user_content.pt"), "rb") as fh:
            user_content = pickle.load(fh)
    else:
        with open(os.path.join(path, tag), "rb") as fh:
            payload = pickle.load(fh)
        # A full checkpoint is a gathered logical state dict: always
        # reshardable.
        saved_cfg = payload.get("smp_config", {})
        _verify(saved_cfg, True, what=f"of full '{tag}'")
        model_sd = payload.get("model")
        opt_sd = payload.get("optimizer") if load_optimizer else None
        user_content = payload.get("user_content")

    if "step_count" in saved_cfg:
        state.step_count = int(saved_cfg["step_count"])
    _stash_or_apply(model_sd, opt_sd)
    logger.info("Resumed from checkpoint '%s' under %s.", tag, path)
    return user_content


def _load_side_file(f):
    """A replicated side file (loss scaler, fp8 state): this rank's
    coordinates' copy, else any saved coordinates' (an elastic resume
    under other coordinates), else None."""
    if os.path.exists(_partial_name(f)):
        return load(f)
    stem, ext = os.path.splitext(f)
    copies = sorted(glob.glob(f"{stem}_*{ext}"))
    if not copies:
        return None
    with open(copies[0], "rb") as fh:
        return pickle.load(fh)


def _live_quant_state():
    """The fp8 delayed-scaling state under ``matmul_precision: fp8`` (made
    here if no step has made it yet), else None."""
    from smdistributed_modelparallel_tpu_torch import quant

    if state.quant_state is None and quant.matmul_precision_mode(state.cfg) == "fp8":
        quant.ensure_state()
    return state.quant_state


def _stash_or_apply(model_sd, opt_sd):
    from smdistributed_modelparallel_tpu_torch.shard_io import ShardCatalog

    model = state.model
    if model is not None:
        if isinstance(model_sd, ShardCatalog):
            model.load_sharded(model_sd)
        else:
            model.load_state_dict(model_sd)
    else:
        state.loaded_model_state = model_sd
    if opt_sd is None:
        return
    opt = state.optimizer
    if opt is not None:
        if isinstance(opt_sd, ShardCatalog):
            opt.load_sharded(opt_sd)
        else:
            opt.load_state_dict(opt_sd)
    else:
        state.loaded_optimizer_state = opt_sd

