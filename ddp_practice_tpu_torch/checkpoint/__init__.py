"""Checkpointing: crash-safe save and restore (counterpart of
ddp_practice_tpu/checkpoint/__init__.py, whose numpy half it copies: the
port imports nothing of the JAX package).

Format, the reference's (`schema_version` 2): a checkpoint is a directory
holding `leaves.npz` (one array per leaf, keyed `leaf_<i>`) and
`manifest.json` (`schema_version`, `paths`: each leaf's name in order,
`extra`: the run's configuration). The port's leaves are named after the
train state it saves (`TrainState`):

- `step`;
- `model.<name>`: every entry of the model's `state_dict`, parameters and
  buffers (BatchNorm running statistics, router biases);
- `optimizer.applies` and `optimizer.micro`: the optimizer chain's apply
  count (the schedule's) and its micro-steps since the last apply;
- `optimizer.state.<param>.<key>`: the torch optimizer's per-parameter
  state (SGD `momentum_buffer`; Adam/AdamW `step`, `exp_avg`,
  `exp_avg_sq`);
- `optimizer.acc.<param>`: the gradient-accumulation mean (accum_steps >
  1).

bf16 tensors are stored as fp32 (numpy has no bf16) and restored in the
target's dtype.

Directory protocol, the reference's:

- each save writes `<dir>/step_<N>/` under a `tmp.` name, with
  `manifest.json` last, and publishes it by `os.rename`; a re-save of
  the same step moves the old directory aside first;
- the newest `keep_last` (default 3) complete checkpoints are kept, and
  older ones are pruned only after the new one is complete; debris of
  crashed saves (`tmp.step_*`, `*.old.*`) is swept after each publish;
- restore takes the newest step whose manifest *parses* (a truncated
  manifest falls back to the previous checkpoint), then a legacy
  single-checkpoint layout (`leaves.npz` in `<dir>` itself), then the
  newest complete `tmp.`/`.old.` directory (the same-step re-save's crash
  window).

Every process calls `save` (the barrier is collective); process 0 alone
writes, the rank-0 gate of the reference's DDP script. The port's state
is dense on every rank (DDP replicas), so there is no shard to write
before the sharded-checkpoint write path arrives (ROADMAP A8).
`save_async` copies the tensors to host memory before it returns, then
serialises and publishes on a thread; it is single-process only, and a
save to a directory with an async write still in flight is refused.

`restore` reads two layouts into the port's `TrainState`:

- the port's own (names above; every model entry must be present, and
  optimizer state the target's optimizer has no use for raises);
- a checkpoint the JAX package wrote: its keystr paths (`.step`,
  `.params[...]`, `.batch_stats[...]`, `.opt_state...`) are parsed into
  nested numpy trees and mapped through `convert.py` (kernel layouts and
  names), including the reference's multi-host layout
  (`shards.<p>.npz` + `shards.<p>.json`, reassembled here by
  `_assemble_shards`). Optimizer state maps where torch has a
  counterpart: SGD's momentum `trace` -> `momentum_buffer`; Adam/AdamW
  `mu`, `nu`, `count` -> `exp_avg`, `exp_avg_sq`, `step`; the schedule's
  `count` -> `optimizer.applies`; MultiSteps' `acc_grads` and
  `mini_step` -> the Welford accumulator and `optimizer.micro`
  (train/state.py). A leaf with no counterpart raises naming it.

Shape mismatches raise with the leaf named, before anything is copied.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as tdist

from ddp_practice_tpu_torch.convert import flax_to_state_dict
from ddp_practice_tpu_torch.parallel import dist

_LEAVES = "leaves.npz"
_MANIFEST = "manifest.json"
_STEP_RE = re.compile(r"^step_(\d+)$")
_SCHEMA_VERSION = 2

# ------------------------------------------------------------ directories


def _complete_steps(directory: str) -> List[int]:
    """Step numbers of complete checkpoints (a manifest exists),
    ascending."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name, _MANIFEST)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def _manifest_ok(ckpt_dir: str) -> bool:
    """True when the manifest parses, not merely exists: a power loss
    inside the json write leaves a manifest that exists and fails to
    parse, and restore must then fall back to an older checkpoint."""
    try:
        with open(os.path.join(ckpt_dir, _MANIFEST)) as f:
            json.load(f)
        return True
    except (OSError, ValueError, UnicodeDecodeError):
        return False


def _resolve(directory: str) -> Optional[str]:
    """The directory holding the checkpoint to restore, or None: the
    newest `step_<N>` whose manifest parses; else the legacy
    single-checkpoint layout; else the newest complete `tmp.step_<N>.*` or
    `step_<N>.old.*` (written manifest last, so complete means whole)."""
    for step in reversed(_complete_steps(directory)):
        cand = os.path.join(directory, f"step_{step}")
        if _manifest_ok(cand):
            return cand
    if os.path.exists(os.path.join(directory, _LEAVES)) \
            and _manifest_ok(directory):
        return directory
    best, best_step = None, -1
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            if not (name.startswith("tmp.step_") or ".old." in name):
                continue
            m = re.search(r"step_(\d+)", name)
            if m and int(m.group(1)) > best_step \
                    and _manifest_ok(os.path.join(directory, name)):
                best, best_step = name, int(m.group(1))
    return os.path.join(directory, best) if best else None


def latest_manifest(directory: str) -> Optional[dict]:
    src = _resolve(directory)
    if src is None:
        return None
    with open(os.path.join(src, _MANIFEST)) as f:
        return json.load(f)


def all_steps(directory: str) -> List[int]:
    """Steps of all retained complete checkpoints (ascending)."""
    return _complete_steps(directory)


def exists(directory: str) -> bool:
    return _resolve(directory) is not None


# ------------------------------------------------------------ save


def _host(t: torch.Tensor) -> np.ndarray:
    """A copy of `t` in host memory (never a view of a live tensor)."""
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.to("cpu", copy=True).numpy()


def _param_names(state) -> Dict[int, str]:
    return {id(p): n for n, p in state.model.named_parameters()}


def state_leaves(state) -> Dict[str, torch.Tensor]:
    """The train state's leaves by checkpoint name, in save order."""
    out = {"step": torch.tensor(int(state.step), dtype=torch.int64)}
    for name, t in state.model.state_dict().items():
        out[f"model.{name}"] = t
    opt = state.optimizer
    out["optimizer.applies"] = torch.tensor(opt.applies, dtype=torch.int64)
    out["optimizer.micro"] = torch.tensor(opt.micro, dtype=torch.int64)
    names = _param_names(state)
    for p in opt.params:
        for key, value in opt.inner.state.get(p, {}).items():
            if isinstance(value, torch.Tensor):
                out[f"optimizer.state.{names[id(p)]}.{key}"] = value
    if opt.acc is not None:
        for p, acc in zip(opt.params, opt.acc):
            out[f"optimizer.acc.{names[id(p)]}"] = acc
    return out


def _normalize_step(extra, step):
    """One place decides the step directory from extra/step (save and
    save_async write identical manifests)."""
    extra = dict(extra or {})
    if step is None:
        step = int(extra.get("step", 0))
    extra.setdefault("step", step)
    return extra, step


def _gather(state):
    """(arrays, names): every leaf copied to host memory."""
    leaves = state_leaves(state)
    names = list(leaves)
    arrays = {f"leaf_{i}": _host(leaves[n]) for i, n in enumerate(names)}
    return arrays, names


def _serialize_into(tmp, arrays, names, extra) -> None:
    """leaves.npz, then manifest.json last: its presence marks the
    checkpoint complete."""
    np.savez(os.path.join(tmp, _LEAVES), **arrays)
    manifest = {"schema_version": _SCHEMA_VERSION, "paths": names,
                "extra": extra}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)


def _write(directory, arrays, names, extra, step, keep_last) -> str:
    """Serialise and publish one checkpoint (host data only)."""
    final = os.path.join(directory, f"step_{step}")
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.step_{step}.{os.getpid()}")
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    _serialize_into(tmp, arrays, names, extra)
    return _publish(directory, tmp, final, keep_last)


def _publish(directory, tmp, final, keep_last) -> str:
    """Rename a complete temp dir into place, prune, sweep debris."""
    if os.path.isdir(final):
        # a re-save of one step (the end-of-fit save on the last periodic
        # one): move the old copy aside first, so no instant leaves
        # step_N deleted with its replacement under an ignored tmp. name
        old = f"{final}.old.{os.getpid()}"
        os.rename(final, old)
        os.rename(tmp, final)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.rename(tmp, final)
    steps = _complete_steps(directory)
    for old in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{old}"),
                      ignore_errors=True)
    for name in os.listdir(directory):
        if name.startswith("tmp.step_") or ".old." in name:
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
    return final


# directories with an async write in flight (abspath -> AsyncSave)
_IN_FLIGHT: Dict[str, "AsyncSave"] = {}
_IN_FLIGHT_LOCK = threading.Lock()


def _refuse_overlap(directory: str) -> None:
    with _IN_FLIGHT_LOCK:
        pending = _IN_FLIGHT.get(os.path.abspath(directory))
    if pending is not None and not pending.done():
        raise RuntimeError(
            f"an async checkpoint write to {directory!r} is still in "
            f"flight ({pending.path}): wait() on its handle first (the "
            "debris sweep of one save may remove another's temp dir)")


def save(directory: str, state, *, extra: Optional[dict] = None,
         step: Optional[int] = None, keep_last: int = 3) -> str:
    """Write a checkpoint of `state` (a TrainState) under `directory`.

    Every process must call it; process 0 writes, and no process returns
    before the checkpoint is on disk. Returns the final path."""
    _refuse_overlap(directory)
    extra, step = _normalize_step(extra, step)
    final = os.path.join(directory, f"step_{step}")
    if dist.is_main_process():
        arrays, names = _gather(state)
        _write(directory, arrays, names, extra, step, keep_last)
    if dist.process_count() > 1:
        tdist.barrier()
    return final


class AsyncSave:
    """Handle for a background checkpoint write (save_async): wait()
    joins the writer and returns the final path, re-raising any write
    error; done() polls."""

    def __init__(self, thread, path: str):
        self._thread = thread
        self._error: list = []
        self.path = path

    def wait(self) -> str:
        self._thread.join()
        if self._error:
            raise self._error[0]
        return self.path

    def done(self) -> bool:
        return not self._thread.is_alive()


def save_async(directory: str, state, *, extra: Optional[dict] = None,
               step: Optional[int] = None,
               keep_last: int = 3) -> AsyncSave:
    """Like save(), but only the copy to host memory happens before it
    returns; serialisation and the rename run on a thread, overlapping
    the next steps. Same crash safety. Single-process only (a multi-rank
    save is a collective whose order must match across ranks). A second
    save to the same directory before wait() is refused."""
    if dist.process_count() > 1:
        raise ValueError("save_async is single-process; multi-rank saves "
                         "are collective: use save()")
    _refuse_overlap(directory)
    extra, step = _normalize_step(extra, step)
    arrays, names = _gather(state)
    final = os.path.join(directory, f"step_{step}")

    def run():
        try:
            _write(directory, arrays, names, extra, step, keep_last)
        except BaseException as e:  # surfaced by wait()
            handle._error.append(e)

    thread = threading.Thread(target=run, name=f"ckpt-write-{step}")
    handle = AsyncSave(thread, final)
    with _IN_FLIGHT_LOCK:
        _IN_FLIGHT[os.path.abspath(directory)] = handle
    thread.start()
    return handle


# ------------------------------------------------------------ restore


def _open_shard_files(src: str):
    """[(index entries, lazy npz)] for every shards.<p> pair under src."""
    out = []
    for name in sorted(os.listdir(src)):
        if not (name.startswith("shards.") and name.endswith(".json")):
            continue
        with open(os.path.join(src, name)) as f:
            index = json.load(f)
        out.append((index, np.load(
            os.path.join(src, name[:-len("json")] + "npz"))))
    return out


def _assemble_shards(src: str, manifest: dict) -> dict:
    """Reassemble the reference's cross-host leaves from every
    shards.<p>.npz under `src` ({leaf index: array}), under any process
    count. Coverage is checked element for element, so a missing
    writer's file raises instead of leaving zeros."""
    meta = manifest.get("sharded_leaves") or {}
    if not meta:
        return {}
    out = {int(i): np.zeros(m["shape"], np.dtype(m["dtype"]))
           for i, m in meta.items()}
    filled = {int(i): 0 for i in meta}
    for index, shards in _open_shard_files(src):
        for entry in index:
            i = int(entry["leaf"])
            sl = tuple(slice(a, b) for a, b in entry["index"])
            out[i][sl] = shards[entry["key"]]
            filled[i] += int(np.prod([b - a for a, b in entry["index"]]))
    for i, m in meta.items():
        want = int(np.prod(m["shape"]))
        if filled[int(i)] != want:
            raise ValueError(
                f"sharded leaf {i} has {filled[int(i)]} of {want} elements "
                f"on disk under {src!r}: shard files from some writer "
                "process are missing (incomplete or non-shared storage?)")
    return out


_KEY = re.compile(r"\.(\w+)|\[(\d+)\]|\['([^']*)'\]")


def parse_keystr(path: str) -> tuple:
    """A JAX keystr (`.opt_state[0].mu['Conv_0']['kernel']`) -> its keys
    (`('opt_state', 0, 'mu', 'Conv_0', 'kernel')`)."""
    keys, pos = [], 0
    for m in _KEY.finditer(path):
        if m.start() != pos:
            break
        attr, index, key = m.groups()
        keys.append(attr if attr is not None
                    else int(index) if index is not None else key)
        pos = m.end()
    if pos != len(path) or not keys:
        raise ValueError(f"checkpoint leaf {path!r} is not a JAX keystr")
    return tuple(keys)


def _nest(tree: dict, keys: tuple, value) -> None:
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


# the reference optimizer-state fields the port has a counterpart for
_OPT_TREES = {"trace": "momentum_buffer", "mu": "exp_avg",
              "nu": "exp_avg_sq", "acc_grads": "acc"}


def _from_jax(paths: List[str], arrays: List[np.ndarray]) -> tuple:
    """The JAX package's train-state leaves -> ({port leaf name: array},
    {port leaf name: the JAX path it came from})."""
    trees: Dict[str, dict] = {}
    adam_count = None            # (path, array) of Adam's own count
    adam_prefixes = set()
    parsed = [parse_keystr(p) for p in paths]
    for keys in parsed:
        for j, k in enumerate(keys):
            if k in ("mu", "nu"):
                adam_prefixes.add(keys[:j])
    out, origin = {}, {}
    for path, keys, arr in zip(paths, parsed, arrays):
        head = keys[0]
        if keys == ("step",):
            out["step"], origin["step"] = arr, path
        elif head in ("params", "batch_stats") and len(keys) > 1:
            _nest(trees.setdefault("model", {}), (head,) + keys[1:],
                  (path, arr))
        elif head == "opt_state":
            kind = next((j for j, k in enumerate(keys)
                         if k in _OPT_TREES), None)
            last = keys[-1]
            if kind is not None and len(keys) > kind + 1:
                _nest(trees.setdefault(keys[kind], {}), keys[kind + 1:],
                      (path, arr))
            elif last == "count" and keys[:-1] in adam_prefixes:
                adam_count = (path, arr)
            elif last in ("count", "gradient_step"):
                name = "optimizer.applies"
                if name in out and int(out[name]) != int(arr):
                    raise ValueError(
                        f"checkpoint leaf {path!r} counts {int(arr)} "
                        f"applies, {origin[name]!r} {int(out[name])}")
                out[name], origin[name] = arr, path
            elif last == "mini_step":
                out["optimizer.micro"] = arr
                origin["optimizer.micro"] = path
            else:
                raise ValueError(
                    f"checkpoint leaf {path!r} has no counterpart in the "
                    "port's optimizer (train/state.py)")
        else:
            raise ValueError(f"checkpoint leaf {path!r} has no counterpart "
                             "in the port's train state")

    def convert(tree, name_of):
        """A nested tree of (path, array) through convert.py's layout and
        naming rules; `name_of` makes the port leaf name."""
        flat, where = {}, []

        def walk(node, keys):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, keys + (k,))
                else:
                    _nest(flat, keys + (k,), v[1])
                    where.append(v[0])

        walk(tree, ())
        # flax_to_state_dict walks in the same order: names pair with paths
        for (name, t), src in zip(flax_to_state_dict(flat).items(), where):
            out[name_of(name)], origin[name_of(name)] = t.numpy(), src

    model = trees.pop("model", {})
    for section in ("params", "batch_stats"):
        if section in model:
            convert(model[section], lambda n: f"model.{n}")
    for kind, tree in trees.items():
        key = _OPT_TREES[kind]
        convert(tree, (lambda n: f"optimizer.acc.{n}") if key == "acc"
                else (lambda n, key=key: f"optimizer.state.{n}.{key}"))
    if adam_count is not None:
        path, arr = adam_count
        for name in [n for n in out if n.endswith(".exp_avg")]:
            new = name[:-len("exp_avg")] + "step"
            out[new], origin[new] = arr, path
    return out, origin


def _check_optimizer_leaf(state, name: str, src: str, params: dict):
    """(param, key) for an optimizer.state/acc leaf the target can take;
    raises naming the leaf otherwise."""
    opt = state.optimizer
    if name.startswith("optimizer.acc."):
        pname = name[len("optimizer.acc."):]
        if opt.acc is None or pname not in params:
            raise ValueError(
                f"checkpoint leaf {src!r}: the target optimizer has no "
                f"gradient accumulator for {pname!r} (accum_steps "
                f"{opt.k})")
        return params[pname], "acc"
    pname, key = name[len("optimizer.state."):].rsplit(".", 1)
    inner = type(opt.inner).__name__
    allowed = {"SGD": {"momentum_buffer"} if opt.inner.defaults.get(
        "momentum") else set(),
        "Adam": {"step", "exp_avg", "exp_avg_sq"},
        "AdamW": {"step", "exp_avg", "exp_avg_sq"}}.get(inner, set())
    if key not in allowed or pname not in params:
        raise ValueError(
            f"checkpoint leaf {src!r} ({key} of {pname!r}) has no "
            f"counterpart in the target's {inner} optimizer")
    return params[pname], key


def restore(directory: str, state):
    """Load the newest complete checkpoint under `directory` into
    `state` (a TrainState: its model and optimizer in place) and return
    it, with `state.step` set. Reads the port's layout and the JAX
    package's; raises on a missing, extra or misshapen leaf, naming it."""
    src = _resolve(directory)
    if src is None:
        raise FileNotFoundError(f"no complete checkpoint under {directory!r}")
    with open(os.path.join(src, _MANIFEST)) as f:
        manifest = json.load(f)
    paths = manifest["paths"]
    assembled = _assemble_shards(src, manifest)
    with np.load(os.path.join(src, _LEAVES)) as data:
        arrays = [assembled[i] if i in assembled else data[f"leaf_{i}"]
                  for i in range(len(paths))]
    if paths and paths[0].startswith((".", "[")):
        leaves, origin = _from_jax(paths, arrays)
    else:
        leaves = dict(zip(paths, arrays))
        origin = {p: p for p in paths}

    model_sd = state.model.state_dict()
    got_model = {n[len("model."):] for n in leaves if n.startswith("model.")}
    missing = sorted(set(model_sd) - got_model)
    extra_model = sorted(got_model - set(model_sd))
    if extra_model:
        name = "model." + extra_model[0]
        raise ValueError(f"checkpoint leaf {origin[name]!r} has no "
                         f"counterpart in the target model")
    if missing:
        raise ValueError(f"checkpoint under {src!r} lacks the model's "
                         f"{missing[0]!r} (and {len(missing) - 1} more)")
    params = dict(state.model.named_parameters())
    opt_leaves = {}
    for name, arr in leaves.items():
        src_name = origin[name]
        if name.startswith("model."):
            want = tuple(model_sd[name[len("model."):]].shape)
        elif name.startswith(("optimizer.state.", "optimizer.acc.")):
            p, key = _check_optimizer_leaf(state, name, src_name, params)
            opt_leaves[name] = (p, key)
            want = () if key == "step" else tuple(p.shape)
        elif name in ("step", "optimizer.applies", "optimizer.micro"):
            want = ()
        else:
            raise ValueError(f"checkpoint leaf {src_name!r} has no "
                             "counterpart in the port's train state")
        if tuple(np.shape(arr)) != want:
            raise ValueError(
                f"checkpoint leaf {src_name!r} has shape "
                f"{tuple(np.shape(arr))}; target wants {want}: the "
                "checkpoint was written with a different model "
                "configuration")

    with torch.no_grad():
        for name, t in model_sd.items():
            t.copy_(torch.from_numpy(np.asarray(leaves[f"model.{name}"])))
    opt = state.optimizer
    slot = {id(p): i for i, p in enumerate(opt.params)}
    for name, (p, key) in opt_leaves.items():
        value = torch.from_numpy(np.array(leaves[name]))
        if key == "acc":
            opt.acc[slot[id(p)]].copy_(value)
        elif key == "step":   # torch keeps Adam's count as a host fp32
            opt.inner.state[p]["step"] = value.to(torch.float32)
        else:
            opt.inner.state[p][key] = value.to(p.device, p.dtype)
    if "optimizer.applies" in leaves:
        opt.applies = int(leaves["optimizer.applies"])
    if "optimizer.micro" in leaves:
        opt.micro = int(leaves["optimizer.micro"])
    if "step" in leaves:
        state.step = int(leaves["step"])
    return state


__all__ = ["AsyncSave", "all_steps", "exists", "latest_manifest",
           "parse_keystr", "restore", "save", "save_async", "state_leaves"]
