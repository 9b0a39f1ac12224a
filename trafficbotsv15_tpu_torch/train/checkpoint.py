"""Checkpoints of a fit: "last" and "best", each with its config (counterpart of
`trafficbotsv15_tpu/train/checkpoint.py`, on torch files).

`<dir>/<name>` is one `torch.save` file of a state dict; `<dir>/<name>.json`
holds `{"config": config_to_dict(cfg), "meta": ...}` in the JAX package's
layout, so its config reads in either package. The contract is the JAX
package's:
  - "best" is top-1 on `val/loss`, lower is better; the best score survives a
    restart (read back from `best.json`);
  - a save writes `<name>.tmp`, then renames the current `<name>` to
    `<name>.old`, the new file to `<name>`, writes the json and drops `.old`, so
    a crash at any point leaves the old or the new checkpoint restorable; a
    restore falls back to `.old` when `<name>` is gone, and a leftover `.tmp`
    is never read and is removed by the next save;
  - `save_last` returns once the state has been copied to host memory; a
    background thread writes it, and the next save, restore or `wait()`
    finalises it (a save that was never finalised is lost, as a save cut by
    preemption is); `save_best` blocks;
  - `restore(name, config_overrides=...)` merges the overrides deeply into the
    saved config (the morph for submission: K=128 futures);
  - `restore_resume(keep)` restores only the entries the run still keeps.
A fit's state holds the model's `state_dict`, the optimizer's and the
schedule's, the accumulation buffers when it accumulates, and `ema`, `swa` and
`swa_state` when they are on. There is no `migrate_param_tree`: it renames
flax leaves of checkpoints older than the JAX package's current param tree,
which the port's state dicts never had. The JAX package's Orbax checkpoints
come across through numpy (`utils/jax_import.py`).

Over several ranks (`parallel/mesh.py`) the state a fit hands in is full and
placement-free on every rank (the fit gathers what FSDP or tensor parallelism
shards, `ShardedParams`, and cuts it again on restore, so a checkpoint restores
under any strategy), so rank 0 alone copies it to the host and writes it (JAX
`_is_proc0`); every rank calls
each save, restore and `wait()` in the same order, and a finalisation ends
with a barrier on every rank after rank 0's swap (for the async "last", after
its thread has joined), so no rank restores a checkpoint before it is in
place. Every rank restores.
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from trafficbotsv15_tpu_torch.config import ExperimentCfg, config_from_dict, config_to_dict
from trafficbotsv15_tpu_torch.parallel.mesh import barrier, process_index


def to_host(obj):
    """A copy of obj with every tensor copied to host memory (dicts, lists and tuples rebuilt)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def deep_update(d: dict, u: dict) -> dict:
    """Merge u into d in place, recursing where both hold a dict; -> d."""
    for k, v in u.items():
        if isinstance(v, dict) and isinstance(d.get(k), dict):
            deep_update(d[k], v)
        else:
            d[k] = v
    return d


class _Write:
    """One background torch.save of a host state into `tmp`; `join()` re-raises its error."""

    def __init__(self, state: Dict[str, Any], tmp: Path):
        self.error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, args=(state, tmp), daemon=True)
        self.thread.start()

    def _run(self, state, tmp):
        try:
            torch.save(state, tmp)
        except Exception as e:  # handed to the thread that finalises the save
            self.error = e

    def join(self) -> None:
        self.thread.join()
        if self.error is not None:
            raise RuntimeError(f"checkpoint write failed: {self.error!r}") from self.error


class CheckpointManager:
    def __init__(self, ckpt_dir: str):
        self.dir = Path(ckpt_dir).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.best_score: Optional[float] = None
        best_meta = self.dir / "best.json"
        if best_meta.exists():
            score = json.loads(best_meta.read_text()).get("meta", {}).get("score")
            if score is not None:
                self.best_score = float(score)
        # (name, write, json payload); on the ranks past 0, which write nothing, (name, None, None)
        self._pending: Optional[Tuple[str, Optional[_Write], Optional[str]]] = None
        self.writes = process_index() == 0

    def _finalize_pending(self) -> None:
        """Wait for the in-flight write, then swap it in: `<name>` -> `<name>.old`, `.tmp` -> `<name>`, the
        json, then `.old` goes; then every rank meets at a barrier."""
        if self._pending is None:
            return
        name, write, payload = self._pending
        self._pending = None
        if write is not None:
            self._swap_in(name, write, payload)
        barrier()

    def _swap_in(self, name: str, write: _Write, payload: str) -> None:
        write.join()
        final, old, tmp = self.dir / name, self.dir / f"{name}.old", self.dir / f"{name}.tmp"
        if final.exists():
            # an older .old goes only when there is a final to replace it: after a crash that left
            # just .old, it stays restorable until the new checkpoint is in place
            old.unlink(missing_ok=True)
            final.rename(old)
        tmp.rename(final)
        json_tmp = self.dir / f"{name}.json.tmp"
        json_tmp.write_text(payload)
        os.replace(json_tmp, self.dir / f"{name}.json")
        old.unlink(missing_ok=True)

    def wait(self) -> None:
        """Block until the in-flight save, if any, is on disk and swapped in (fit calls it before it returns)."""
        self._finalize_pending()

    def _save(self, name: str, state: Dict[str, Any], cfg: ExperimentCfg, meta: Dict[str, Any],
              block: bool) -> None:
        self._finalize_pending()
        if self.writes:
            tmp = self.dir / f"{name}.tmp"
            tmp.unlink(missing_ok=True)  # a leftover of a crashed save
            host = to_host(state)
            self._pending = (name, _Write(host, tmp), json.dumps({"config": config_to_dict(cfg), "meta": meta}))
        else:
            self._pending = (name, None, None)
        if block:
            self._finalize_pending()

    def path(self, name: str) -> Path:
        """The file of checkpoint `name`, or its pre-swap `.old` copy when a crash hit between the renames."""
        final, old = self.dir / name, self.dir / f"{name}.old"
        return old if not final.exists() and old.exists() else final

    def save_last(self, state: Dict[str, Any], cfg: ExperimentCfg, meta: Dict[str, Any]) -> None:
        """Returns once state is copied to host memory; the write overlaps what follows and is finalised by
        the next save, restore or wait()."""
        self._save("last", state, cfg, meta, block=False)

    def save_best(self, state: Dict[str, Any], cfg: ExperimentCfg, score: float, meta: Dict[str, Any]) -> bool:
        """Keep top-1 on score (lower is better). Blocks: True means the new best is on disk. Over several ranks
        the score must be the same on every rank (validation's metrics are)."""
        if self.best_score is None or score < self.best_score:
            self.best_score = score
            self._save("best", state, cfg, {**meta, "score": score}, block=True)
            return True
        return False

    def restore(self, name: str = "last", config_overrides: Optional[Dict[str, Any]] = None
                ) -> Tuple[Dict[str, Any], ExperimentCfg, Dict[str, Any]]:
        """(state on the CPU, the saved config with config_overrides merged in deeply, meta)."""
        self._finalize_pending()
        info = json.loads((self.dir / f"{name}.json").read_text())
        cfg = config_from_dict(deep_update(info["config"], config_overrides or {}))
        state = torch.load(self.path(name), map_location="cpu", weights_only=True)
        return state, cfg, info["meta"]

    def restore_resume(self, keep: Iterable[str], name: str = "last"
                       ) -> Tuple[Dict[str, Any], ExperimentCfg, Dict[str, Any]]:
        """restore(name) with only the entries in `keep`: a run that no longer keeps an EMA skips the saved
        one, and one that keeps an entry the checkpoint lacks starts that entry afresh."""
        state, cfg, meta = self.restore(name)
        keep = set(keep)
        return {k: v for k, v in state.items() if k in keep}, cfg, meta
