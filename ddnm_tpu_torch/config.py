"""Configuration layer: the main pipeline's nested YAML as a dataclass tree.

Port of `ddnm_tpu/config.py`: the main layer (the dataclasses,
`Config.from_dict` and `load_config`) and the hq pipeline's flat layer
(`HQConfig`, `load_hq_config`: one dict, missing keys read as None, dotted
lookups with `pget`).

The machine that runs the port has no `yaml` package, so `parse_yaml` is a
small reader of the YAML subset the shipped configs use: block mappings,
flow maps `{ a: 1 }` and flow lists `[1, 2]`, plain and quoted scalars
resolved as PyYAML's safe loader resolves them (YAML 1.1 ints, floats such
as `1.0e-4`, booleans, null), comments and a leading byte-order mark.
Anything outside that subset raises ValueError instead of being misread.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

__all__ = [
    "DataConfig",
    "ModelConfig",
    "DiffusionConfig",
    "SamplingConfig",
    "TimeTravelConfig",
    "ClassifierConfig",
    "Config",
    "load_config",
    "HQConfig",
    "load_hq_config",
    "parse_yaml",
]


# ------------------------------------------------------------------ YAML subset

# PyYAML's implicit resolvers (resolver.py, YAML 1.1), restricted to the
# forms a config can hold.
_BOOL = {
    **{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE",
                         "on", "On", "ON")},
    **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE",
                          "off", "Off", "OFF")},
}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[-+]?0x[0-9a-fA-F_]+)$"
)
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"
)
_SEXAGESIMAL = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")


def _plain_scalar(text: str) -> Any:
    s = text.strip()
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _SEXAGESIMAL.match(s):
        raise ValueError(f"sexagesimal YAML number not supported: {s!r}")
    if _INT.match(s):
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if len(v) > 1 and v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(s):
        v = s.replace("_", "").lower()
        if v.endswith(".inf"):
            return float("-inf") if v[0] == "-" else float("inf")
        if v.endswith(".nan"):
            return float("nan")
        return float(v)
    if s[0] in "&*!|>%@`" or s.startswith(("- ", "? ")) or s == "-":
        raise ValueError(f"unsupported YAML syntax: {s!r}")
    return s


_ESCAPES = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/", "0": "\0",
            "r": "\r"}


def _quoted(text: str, i: int) -> tuple[str, int]:
    """Parse a quoted scalar starting at text[i]; returns (value, end)."""
    q = text[i]
    out = []
    i += 1
    while i < len(text):
        ch = text[i]
        if q == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and ch == "\\":
            esc = text[i + 1:i + 2]
            if esc not in _ESCAPES:
                raise ValueError(f"unsupported escape \\{esc} in {text!r}")
            out.append(_ESCAPES[esc])
            i += 2
            continue
        if q == '"' and ch == '"':
            return "".join(out), i + 1
        out.append(ch)
        i += 1
    raise ValueError(f"unterminated quoted string: {text!r}")


def _strip_comment(line: str) -> str:
    """Drop a `#` comment that is not inside quotes."""
    q = None
    for i, ch in enumerate(line):
        if q:
            if ch == q:
                q = None
        elif ch in "'\"":
            q = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


class _Flow:
    """Recursive-descent reader of one flow collection ({...} or [...])."""

    def __init__(self, text: str):
        self.s = text
        self.i = 0

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t\n":
            self.i += 1

    def value(self):
        self._ws()
        ch = self.s[self.i:self.i + 1]
        if ch == "{":
            return self._mapping()
        if ch == "[":
            return self._sequence()
        if ch in ("'", '"'):
            v, self.i = _quoted(self.s, self.i)
            return v
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            if c in ",]}":
                break
            if c == ":" and self.s[self.i + 1:self.i + 2] in (" ", ",", "]",
                                                             "}", ""):
                break
            self.i += 1
        return _plain_scalar(self.s[start:self.i])

    def _expect(self, ch):
        self._ws()
        if self.s[self.i:self.i + 1] != ch:
            raise ValueError(f"expected {ch!r} at {self.i} in {self.s!r}")
        self.i += 1

    def _mapping(self):
        self._expect("{")
        out = {}
        self._ws()
        if self.s[self.i:self.i + 1] == "}":
            self.i += 1
            return out
        while True:
            key = self.value()
            self._expect(":")
            self._ws()
            if self.s[self.i:self.i + 1] in (",", "}"):
                out[key] = None
            else:
                out[key] = self.value()
            self._ws()
            ch = self.s[self.i:self.i + 1]
            self.i += 1
            if ch == "}":
                return out
            if ch != ",":
                raise ValueError(f"bad flow mapping: {self.s!r}")
            self._ws()
            if self.s[self.i:self.i + 1] == "}":
                self.i += 1
                return out

    def _sequence(self):
        self._expect("[")
        out = []
        self._ws()
        if self.s[self.i:self.i + 1] == "]":
            self.i += 1
            return out
        while True:
            out.append(self.value())
            self._ws()
            ch = self.s[self.i:self.i + 1]
            self.i += 1
            if ch == "]":
                return out
            if ch != ",":
                raise ValueError(f"bad flow sequence: {self.s!r}")
            self._ws()
            if self.s[self.i:self.i + 1] == "]":
                self.i += 1
                return out


def _flow_value(text: str) -> Any:
    reader = _Flow(text)
    v = reader.value()
    reader._ws()
    if reader.i != len(text):
        raise ValueError(f"trailing text after flow value: {text!r}")
    return v


def _split_key(content: str) -> tuple[Any, str]:
    """Split a block-mapping line `key: rest` into (key, rest)."""
    if content[0] in ("'", '"'):
        key, i = _quoted(content, 0)
    else:
        m = re.search(r":(?:\s|$)", content)
        if m is None:
            raise ValueError(f"not a mapping entry: {content!r}")
        i = m.start()
        key = _plain_scalar(content[:i])
    rest = content[i:].lstrip()
    if not rest.startswith(":"):
        raise ValueError(f"not a mapping entry: {content!r}")
    return key, rest[1:].strip()


def parse_yaml(text: str) -> Any:
    """Parse the YAML subset described in the module docstring."""
    if text.startswith("\ufeff"):
        text = text[1:]
    lines = []
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError("tab indentation is not YAML")
        body = _strip_comment(raw).rstrip()
        if body.strip() in ("", "---"):
            continue
        lines.append((len(body) - len(body.lstrip(" ")), body.strip()))
    if not lines:
        return None
    value, end = _block(lines, 0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"unexpected indentation at: {lines[end][1]!r}")
    return value


def _block(lines, pos, indent):
    """Parse the block mapping whose keys sit at `indent`, from lines[pos]."""
    out = {}
    while pos < len(lines) and lines[pos][0] == indent:
        key, rest = _split_key(lines[pos][1])
        pos += 1
        if rest == "":
            if pos < len(lines) and lines[pos][0] > indent:
                out[key], pos = _block(lines, pos, lines[pos][0])
            else:
                out[key] = None
        elif rest[0] in "{[":
            # a flow collection may continue on more-indented lines
            text = rest
            while _depth(text) > 0 and pos < len(lines) and lines[pos][0] > indent:
                text += " " + lines[pos][1]
                pos += 1
            out[key] = _flow_value(text)
        elif rest[0] in ("'", '"'):
            v, i = _quoted(rest, 0)
            if rest[i:].strip():
                raise ValueError(f"trailing text after string: {rest!r}")
            out[key] = v
        else:
            out[key] = _plain_scalar(rest)
    if pos < len(lines) and lines[pos][0] > indent:
        raise ValueError(f"unexpected indentation at: {lines[pos][1]!r}")
    return out, pos


def _depth(text: str) -> int:
    d, q = 0, None
    for ch in text:
        if q:
            if ch == q:
                q = None
        elif ch in "'\"":
            q = ch
        elif ch in "[{":
            d += 1
        elif ch in "]}":
            d -= 1
    return d


# ----------------------------------------------------------------- dataclasses


def _build(cls, d: dict[str, Any]):
    """Construct dataclass `cls` from dict, stashing unknown keys in .extra."""
    names = {f.name for f in dataclasses.fields(cls)}
    known = {k: v for k, v in d.items() if k in names and k != "extra"}
    extra = {k: v for k, v in d.items() if k not in names}
    obj = cls(**known)
    if extra and hasattr(obj, "extra"):
        obj.extra.update(extra)
    return obj


@dataclass
class DataConfig:
    dataset: str = "CelebA_HQ"
    category: str = ""
    image_size: int = 256
    channels: int = 3
    logit_transform: bool = False
    uniform_dequantization: bool = False
    gaussian_dequantization: bool = False
    random_flip: bool = False
    rescaled: bool = True
    num_workers: int = 0
    out_of_dist: bool = True
    extra: dict[str, Any] = field(default_factory=dict)


@dataclass
class ModelConfig:
    type: str = "simple"  # "simple" (DDPM UNet) | "openai" (ADM UNet)
    # --- "simple" model fields (configs/celeba_hq.yml) ---
    ch: int = 128
    out_ch: int = 3
    ch_mult: tuple = (1, 1, 2, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: tuple = (16,)
    dropout: float = 0.0
    in_channels: int = 3
    var_type: str = "fixedsmall"
    ema_rate: float = 0.999
    ema: bool = True
    resamp_with_conv: bool = True
    # --- "openai"/ADM model fields (configs/imagenet_256.yml) ---
    image_size: int = 256
    num_channels: int = 256
    num_heads: int = 4
    num_heads_upsample: int = -1
    num_head_channels: int = 64
    attention_resolutions: str = "32,16,8"
    channel_mult: str = ""
    use_scale_shift_norm: bool = True
    resblock_updown: bool = True
    learn_sigma: bool = True
    class_cond: bool = False
    use_checkpoint: bool = False
    use_fp16: bool = True
    use_new_attention_order: bool = False
    extra: dict[str, Any] = field(default_factory=dict)


@dataclass
class DiffusionConfig:
    beta_schedule: str = "linear"
    beta_start: float = 0.0001
    beta_end: float = 0.02
    num_diffusion_timesteps: int = 1000
    extra: dict[str, Any] = field(default_factory=dict)


@dataclass
class SamplingConfig:
    batch_size: int = 1
    last_only: bool = True
    extra: dict[str, Any] = field(default_factory=dict)


@dataclass
class TimeTravelConfig:
    T_sampling: int = 100
    travel_length: int = 1
    travel_repeat: int = 1
    extra: dict[str, Any] = field(default_factory=dict)


@dataclass
class ClassifierConfig:
    image_size: int = 256
    classifier_use_fp16: bool = True
    classifier_width: int = 128
    classifier_depth: int = 2
    classifier_attention_resolutions: str = "32,16,8"
    classifier_use_scale_shift_norm: bool = True
    classifier_resblock_updown: bool = True
    classifier_pool: str = "attention"
    classifier_scale: float = 1.0
    extra: dict[str, Any] = field(default_factory=dict)


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    time_travel: TimeTravelConfig = field(default_factory=TimeTravelConfig)
    classifier: Optional[ClassifierConfig] = None
    extra: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        sections = {
            "data": DataConfig,
            "model": ModelConfig,
            "diffusion": DiffusionConfig,
            "sampling": SamplingConfig,
            "time_travel": TimeTravelConfig,
            "classifier": ClassifierConfig,
        }
        kwargs: dict[str, Any] = {}
        extra: dict[str, Any] = {}
        for k, v in d.items():
            if k in sections and isinstance(v, dict):
                kwargs[k] = _build(sections[k], v)
            else:
                extra[k] = v
        cfg = cls(**kwargs)
        cfg.extra.update(extra)
        return cfg


def load_config(path: str | Path) -> Config:
    raw = parse_yaml(Path(path).read_text(encoding="utf-8"))
    for key in ("ch_mult", "attn_resolutions"):
        if "model" in raw and key in raw["model"] and raw["model"][key] is not None:
            raw["model"][key] = tuple(raw["model"][key])
    return Config.from_dict(raw)


class HQConfig(dict):
    """Flat hq-pipeline config: attribute access, missing keys read as None
    (the reference's NoneDict / Default_Conf behaviour)."""

    def __getattr__(self, name: str):
        return self.get(name)

    def pget(self, dotted: str, default=None):
        """Dotted-path lookup, e.g. pget('schedule_jump_params.t_T')."""
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node


def load_hq_config(path: str | Path) -> HQConfig:
    return HQConfig(parse_yaml(Path(path).read_text(encoding="utf-8")) or {})
