"""Config system: YAML trees with group selection, ``${...}`` interpolation
and dotted CLI overrides.

Port of ``skeletondiffusion_tpu/utils/config.py`` (the reference's
Hydra/OmegaConf stack, `train_diffusion.py:4-7`, `src/utils/config.py`), on
``yaml_lite`` in place of PyYAML:

* ``defaults: [_self_, {task: hmp}, {dataset: amass}]`` — group entries pull
  ``<group>/<option>.yaml`` into ``cfg[<group>]``;
* ``${a.b.c}`` interpolation (the whole value or inside a string);
* ``${eval:'expr'}`` arithmetic on interpolated values (the reference
  registers the same resolver, `train_diffusion.py:7`);
* CLI overrides ``group=option`` (selects a group file) and ``a.b.c=value``
  (a leaf, its value read as YAML).
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from . import yaml_lite


def _lookup(cfg: Dict, dotted: str):
    cur: Any = cfg
    for part in dotted.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            raise KeyError(dotted)
    return cur


def _resolve_value(expr: str, root: Dict):
    expr = expr.strip()
    if expr.startswith("eval:"):
        body = expr[len("eval:"):].strip()
        if (body.startswith("'") and body.endswith("'")) or (
            body.startswith('"') and body.endswith('"')
        ):
            body = body[1:-1]
        body = _interpolate_str(body, root)
        return eval(body, {"__builtins__": {}}, {"int": int, "float": float, "min": min, "max": max})
    return _lookup(root, expr)


def _find_interp(s: str):
    """The first balanced ``${...}`` span (nested braces included) →
    (start, end exclusive, inner), or None."""
    start = s.find("${")
    if start < 0:
        return None
    depth = 0
    quote = None  # braces inside quoted ${eval:"..."} bodies are literal
    for i in range(start, len(s)):
        c = s[i]
        if quote is not None:
            if c == quote:
                quote = None
            continue
        if c in ("'", '"'):
            quote = c
        elif s.startswith("${", i):
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0:
                return start, i + 1, s[start + 2 : i]
    raise ValueError(f"unbalanced interpolation in {s!r}")


def _interpolate_str(s: str, root: Dict) -> str:
    span = _find_interp(s)
    while span is not None:
        a, b, inner = span
        v = _resolve_value(inner, root)
        s = s[:a] + str(v) + s[b:]
        span = _find_interp(s)
    return s


def _interpolate(node: Any, root: Dict) -> Any:
    if isinstance(node, dict):
        return {k: _interpolate(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_interpolate(v, root) for v in node]
    if isinstance(node, str):
        stripped = node.strip()
        span = _find_interp(stripped)
        if span is not None and span[0] == 0 and span[1] == len(stripped):
            v = _resolve_value(span[2], root)
            return _interpolate(v, root) if isinstance(v, (dict, list, str)) else v
        if span is not None:
            return _interpolate_str(node, root)
    return node


def _deep_merge(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(
    config_dir: str, overrides: Optional[List[str]] = None, resolve: bool = True
) -> Dict[str, Any]:
    """``<config_dir>/config.yaml`` with its default groups and the
    overrides."""
    overrides = list(overrides or [])
    cfg = yaml_lite.read(os.path.join(config_dir, "config.yaml")) or {}
    cfg.pop("hydra", None)
    defaults = cfg.pop("defaults", [])

    # group selections: the defaults list, overridable from the CLI (group=option)
    selections: Dict[str, str] = {}
    order: List[str] = []
    for entry in defaults:
        if isinstance(entry, dict):
            for g, opt in entry.items():
                if str(g).startswith("override"):
                    continue
                selections[g] = opt
                order.append(g)
    kv_overrides: List[str] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov}")
        key, val = ov.split("=", 1)
        if key in selections:
            selections[key] = val
        else:
            kv_overrides.append(ov)

    for group in order:
        sub = yaml_lite.read(os.path.join(config_dir, group, f"{selections[group]}.yaml")) or {}
        cfg[group] = _deep_merge(cfg.get(group, {}) if isinstance(cfg.get(group), dict) else {}, sub)

    for ov in kv_overrides:
        key, val = ov.split("=", 1)
        parts = key.split(".")
        cur = cfg
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = yaml_lite.load(val)

    if resolve:
        cfg = _interpolate(cfg, cfg)
    return cfg


# the config groups whose keys flatten_config lifts to the top level
GROUPS = ("task", "dataset", "model", "method_specs", "cov_matrix")


def flatten_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The ``GROUPS`` sub-dicts merged into the top level (reference
    `src/utils/config.py:66-74`): group keys win over the top level's."""
    out = {k: v for k, v in cfg.items() if k not in GROUPS}
    for g in GROUPS:
        if isinstance(cfg.get(g), dict):
            out.update(cfg[g])
    return out


def save_config(cfg: Dict[str, Any], path: str):
    """The experiment folder's config snapshot; reference `config.py:77-87`."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    yaml_lite.write(cfg, path)


def snapshot_code(out_dir: str):
    """A copy of the port's source in the experiment folder, so that a run
    can be repeated with the code that made it (reference
    `src/utils/config.py:88-96`, which copies the source tree): one zip of
    ``skeletondiffusion_tpu_torch/**/*.py`` and ``chip_smoke.py``, and the git
    revision.  It never fails a run."""
    import subprocess
    import zipfile

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    repo_root = os.path.dirname(pkg_root)
    os.makedirs(out_dir, exist_ok=True)
    try:
        with zipfile.ZipFile(os.path.join(out_dir, "code_snapshot.zip"), "w",
                             zipfile.ZIP_DEFLATED) as zf:
            for base, _, files in os.walk(pkg_root):
                if "__pycache__" in base:
                    continue
                for fn in files:
                    if fn.endswith(".py"):
                        full = os.path.join(base, fn)
                        zf.write(full, os.path.relpath(full, repo_root))
            smoke = os.path.join(repo_root, "chip_smoke.py")
            if os.path.exists(smoke):
                zf.write(smoke, "chip_smoke.py")
        rev = subprocess.run(["git", "-C", repo_root, "rev-parse", "HEAD"],
                             capture_output=True, text=True, timeout=10)
        if rev.returncode == 0:
            with open(os.path.join(out_dir, "git_revision.txt"), "w") as f:
                f.write(rev.stdout)
    except (OSError, subprocess.SubprocessError):
        pass  # a snapshot must never break training


def load_and_merge_autoenc_cfg(diff_cfg: Dict[str, Any], autoenc_cfg_path: str) -> Dict[str, Any]:
    """Stage 2 inherits the AutoEncoder experiment's stored config, its own
    keys winning; reference `src/utils/config.py:14-31`."""
    return _deep_merge(yaml_lite.read(autoenc_cfg_path), diff_cfg)
