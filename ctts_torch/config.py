"""Config loading without PyYAML.

Same returned structure as ``ctts_tpu/config.py``: three raw dicts
(preprocess, model, train) read from ``configs/<dataset>.yaml`` (merged
format) or ``configs/<dataset>/{preprocess,model,train}.yaml``, with
``cwt_scales`` injected when ``pitch_type == "cwt"``.

:func:`load_yaml` reads the subset of YAML the repository's config files
use: block mappings nested by indentation, flow lists (``[a, [b, c]]``),
plain and quoted scalars with YAML 1.1 typing (as ``yaml.safe_load``
resolves them), and ``#`` comments.
"""

import json
import os
import re

from ctts_torch.ops.cwt import get_lf0_cwt

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# YAML 1.1 implicit resolvers of PyYAML's SafeLoader, restricted to the
# forms a config uses
_BOOL = {"yes": True, "no": False, "true": True, "false": False,
         "on": True, "off": False}
_INT_RE = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT_RE = re.compile(
    r"^[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
    r"|^[-+]?\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_INF_RE = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN_RE = re.compile(r"^\.(?:nan|NaN|NAN)$")


def _scalar(text):
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "\"'":
        body = s[1:-1]
        if s[0] == '"':
            return body.encode().decode("unicode_escape")
        return body.replace("''", "'")
    if s in ("", "~", "null", "Null", "NULL"):
        return None
    low = s.lower()
    if low in _BOOL and s in (low, low.capitalize(), low.upper()):
        return _BOOL[low]
    if _INT_RE.match(s):
        return int(s.replace("_", ""))
    if _FLOAT_RE.match(s):
        return float(s.replace("_", ""))
    if _INF_RE.match(s):
        return float("-inf") if s[0] == "-" else float("inf")
    if _NAN_RE.match(s):
        return float("nan")
    return s


def _strip_comment(line):
    """Drop a ``#`` comment that is not inside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _flow(text):
    """Parse a flow sequence such as ``[1, "a", [2, 3]]``."""
    pos = 0

    def parse():
        nonlocal pos
        assert text[pos] == "["
        pos += 1
        items = []
        while True:
            while text[pos] in " \t":
                pos += 1
            if text[pos] == "]":
                pos += 1
                return items
            if text[pos] == "[":
                items.append(parse())
            else:
                start, quote = pos, None
                while quote or text[pos] not in ",]":
                    if quote and text[pos] == quote:
                        quote = None
                    elif not quote and text[pos] in "\"'":
                        quote = text[pos]
                    pos += 1
                items.append(_scalar(text[start:pos]))
            while text[pos] in " \t":
                pos += 1
            if text[pos] == ",":
                pos += 1

    out = parse()
    if text[pos:].strip():
        raise ValueError(f"trailing text after flow list: {text!r}")
    return out


def _value(text):
    text = text.strip()
    return _flow(text) if text.startswith("[") else _scalar(text)


def load_yaml(stream_or_text):
    """Parse the config subset of YAML; returns nested dicts and lists."""
    text = (stream_or_text if isinstance(stream_or_text, str)
            else stream_or_text.read())
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if line.strip():
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))

    root = {}
    stack = [(-1, root)]              # (indent of the mapping's keys, dict)
    for i, (indent, body) in enumerate(lines):
        while indent <= stack[-1][0]:
            stack.pop()
        key, sep, rest = body.partition(":")
        if not sep or (rest and not rest.startswith((" ", "\t"))):
            raise ValueError(f"unsupported YAML line: {body!r}")
        key = _scalar(key)
        parent = stack[-1][1]
        if rest.strip():
            parent[key] = _value(rest)
        elif i + 1 < len(lines) and lines[i + 1][0] > indent:
            parent[key] = child = {}
            stack.append((indent, child))
        else:
            parent[key] = None
    return root


def _dump_scalar(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        if "." not in text:                    # YAML 1.1 floats need a dot
            mant, _, exp = text.partition("e")
            text = f"{mant}.0" + (f"e{exp}" if exp else "")
        return text
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_scalar(x) for x in v) + "]"
    return json.dumps(str(v))


def dump_yaml(mapping, indent=0):
    """A nested mapping of scalars and lists as YAML text that
    :func:`load_yaml` (and ``yaml.safe_load``) read back to the same
    values: block mappings, flow lists, double-quoted strings."""
    lines = []
    for key, value in mapping.items():
        pad = " " * indent
        if isinstance(value, dict):
            lines.append(f"{pad}{key}:")
            lines.append(dump_yaml(value, indent + 2))
        else:
            lines.append(f"{pad}{key}: {_dump_scalar(value)}")
    return "\n".join(ln for ln in lines if ln)


def _default_config_dir():
    return os.path.join(_REPO_ROOT, "configs")


def get_configs_of(dataset, config_dir=None):
    """Load (preprocess_config, model_config, train_config) for a dataset
    (ctts_tpu/config.py:27-56)."""
    config_dir = config_dir or _default_config_dir()
    merged_path = os.path.join(config_dir, dataset + ".yaml")
    trio_dir = os.path.join(config_dir, dataset)

    if os.path.isfile(merged_path):
        with open(merged_path) as f:
            merged = load_yaml(f)
        preprocess = merged["preprocess"]
        model = merged["model"]
        train = merged["train"]
        preprocess.setdefault("dataset", merged.get("dataset", dataset))
    elif os.path.isdir(trio_dir):
        def _load(name):
            with open(os.path.join(trio_dir, name + ".yaml")) as f:
                return load_yaml(f)
        preprocess, model, train = (_load("preprocess"), _load("model"),
                                    _load("train"))
    else:
        raise FileNotFoundError(
            f"no config for dataset {dataset!r} under {config_dir}")

    inject_derived(preprocess, model, train)
    return preprocess, model, train


def inject_derived(preprocess_config, model_config, train_config):
    """Compute startup-injected values (ctts_tpu/config.py:59-66)."""
    pitch = preprocess_config["preprocessing"]["pitch"]
    if pitch.get("pitch_type") == "cwt":
        import numpy as np
        _, scales = get_lf0_cwt(np.ones(10))
        pitch["cwt_scales"] = scales
    return preprocess_config, model_config, train_config
