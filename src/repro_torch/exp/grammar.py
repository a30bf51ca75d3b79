"""The experiment-spec grammar: one parser for every frontend.

Methods and scenarios are declared as call-shaped strings::

    haf(agent=qwen3-32b-sim, critic_path=@critic, K=3)
    haf-llm(cmd="vllm serve model | jq .shortlist")
    flash-crowd(rho=0.95, n_ai_requests=4000)
    paper(rho=0.75, label="rho=0.75")

One grammar serves the ``--methods``/``--scenarios`` CLI flags, the
``methods``/``scenarios`` lists of spec files, and the canonical string
form reports embed — replacing the ad-hoc comma-split parsing that made
``haf-llm:<cmd>`` unable to contain commas and gave every method its own
bespoke CLI flag.

Forms::

    entry   :=  name | name "(" [kv ("," kv)*] ")"
    kv      :=  key "=" value
    value   :=  '"' escaped '"' | "'" escaped "'" | bare

Bare values parse as int / float / true / false / none, else string;
quoted values are always strings (commas, parens and ``=`` included), so
shell commands need no escaping beyond ``\"`` and ``\\``.  The reserved
``label`` key names the entry in reports (default: the entry name).
:func:`format_method` / :func:`format_scenario` emit the canonical string
back — ``parse(format(parse(text)))`` is the identity on the dict.

Seeds use their own small grammar (:func:`parse_seeds`): a bare count
(``3`` → 0,1,2), an explicit list (``0,2,5``), or inclusive ranges
(``0..4``, mixable with the list form).
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

__all__ = [
    "GrammarError", "split_top", "parse_value", "format_value",
    "parse_call", "parse_method", "parse_methods", "parse_scenario",
    "parse_scenarios", "parse_seeds", "format_method", "format_scenario",
]


class GrammarError(ValueError):
    """A spec string that does not parse; the message says how to fix it."""


NAME_RE = re.compile(r"[A-Za-z0-9_.+-]+")
# a string that can ride bare (unquoted) AND re-parse as itself
_BARE_SAFE_RE = re.compile(r"[A-Za-z0-9_.@/:+*?\[\]<>|~^-]+")
_INT_RE = re.compile(r"[+-]?\d+")
_FLOAT_RE = re.compile(r"[+-]?(\d+\.\d*|\.\d+|\d+)([eE][+-]?\d+)?")


def split_top(text: str, sep: str = ",") -> List[str]:
    """Split at top level only: separators inside ``(...)`` or quotes stay."""
    out: List[str] = []
    buf: List[str] = []
    depth = 0
    quote: Optional[str] = None
    i = 0
    while i < len(text):
        ch = text[i]
        if quote is not None:
            buf.append(ch)
            if ch == "\\" and i + 1 < len(text):
                buf.append(text[i + 1])
                i += 1
            elif ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
            buf.append(ch)
        elif ch == "(":
            depth += 1
            buf.append(ch)
        elif ch == ")":
            depth -= 1
            buf.append(ch)
        elif ch == sep and depth == 0:
            out.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
        i += 1
    if quote is not None:
        raise GrammarError(f"unterminated {quote} quote in {text!r}")
    if depth != 0:
        raise GrammarError(f"unbalanced parentheses in {text!r}")
    out.append("".join(buf))
    return out


def _unquote(tok: str) -> str:
    quote = tok[0]
    if len(tok) < 2 or tok[-1] != quote:
        raise GrammarError(f"unterminated {quote} quote in {tok!r}")
    body = tok[1:-1]
    out: List[str] = []
    i = 0
    while i < len(body):
        ch = body[i]
        if ch == "\\" and i + 1 < len(body) and body[i + 1] in ("\\", quote):
            out.append(body[i + 1])
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def parse_value(tok: str):
    """One grammar value: quoted → str; bare → int/float/bool/none/str."""
    tok = tok.strip()
    if tok and tok[0] in "\"'":
        return _unquote(tok)
    if tok in ("true", "True"):
        return True
    if tok in ("false", "False"):
        return False
    if tok in ("none", "None", "null"):
        return None
    if _INT_RE.fullmatch(tok):
        return int(tok)
    if _FLOAT_RE.fullmatch(tok):
        return float(tok)
    return tok


def format_value(v) -> str:
    """Canonical string for a value; ``parse_value(format_value(v)) == v``."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "none"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return repr(v)
    if not isinstance(v, str):
        raise GrammarError(f"cannot format {type(v).__name__} value {v!r}; "
                           "grammar values are scalars")
    if _BARE_SAFE_RE.fullmatch(v) and parse_value(v) == v:
        return v
    return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'


def parse_call(text: str) -> Optional[Tuple[str, Dict]]:
    """``name(k=v, ...)`` → ``(name, params)``; None if not call-shaped."""
    text = text.strip()
    m = NAME_RE.match(text)
    if not m or m.end() == len(text) or text[m.end()] != "(":
        return None
    name = m.group(0)
    if not text.endswith(")"):
        raise GrammarError(f"{text!r}: expected closing ')'")
    body = text[m.end() + 1:-1]
    params: Dict = {}
    for part in split_top(body):
        part = part.strip()
        if not part:
            continue
        key, eq, val = _split_kv(part)
        if not eq:
            raise GrammarError(
                f"{text!r}: argument {part!r} is not key=value "
                "(the grammar takes named arguments only)")
        key = key.strip()
        if not NAME_RE.fullmatch(key):
            raise GrammarError(f"{text!r}: bad argument name {key!r}")
        if key in params:
            raise GrammarError(f"{text!r}: duplicate argument {key!r}")
        params[key] = parse_value(val)
    return name, params


def _split_kv(part: str) -> Tuple[str, bool, str]:
    """Split on the first ``=`` outside quotes."""
    quote: Optional[str] = None
    i = 0
    while i < len(part):
        ch = part[i]
        if quote is not None:
            if ch == "\\":
                i += 1
            elif ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "=":
            return part[:i], True, part[i + 1:]
        i += 1
    return part, False, ""


def _pop_label(name: str, params: Dict) -> str:
    label = params.pop("label", None)
    if label is None:
        return name
    if not isinstance(label, str):
        label = format_value(label)
    return label


LEGACY_HAF_LLM = "haf-llm:"


def parse_method(text: str) -> Dict:
    """One method entry → canonical ``{"name", "params", "label"}``.

    Accepts the grammar call form, a bare registered name, and the legacy
    ``haf-llm:<cmd>`` sugar (whose command cannot contain commas — the
    grammar form ``haf-llm(cmd="...")`` has no such limit).
    """
    text = text.strip()
    if not text:
        raise GrammarError("empty method entry")
    call = parse_call(text)
    if call is not None:
        name, params = call
        # `critic` is sugar for `critic_path` on the HAF methods, so specs
        # read naturally: haf(critic=@critic)
        if name in ("haf", "haf-llm") and "critic" in params:
            if "critic_path" in params:
                raise GrammarError(f"{text!r}: give critic= or critic_path=,"
                                   " not both")
            params["critic_path"] = params.pop("critic")
        label = _pop_label(name, params)
        return {"name": name, "params": params, "label": label}
    if text.startswith(LEGACY_HAF_LLM):
        cmd = text[len(LEGACY_HAF_LLM):]
        return {"name": "haf-llm", "params": {"cmd": cmd},
                "label": f"haf-llm({cmd})"}
    if NAME_RE.fullmatch(text):
        return {"name": text, "params": {}, "label": text}
    raise GrammarError(
        f"cannot parse method entry {text!r}; expected a name, "
        "name(k=v, ...), or haf-llm(cmd=\"...\")")


def parse_methods(text: str) -> List[Dict]:
    """A comma-separated method list (commas inside ``(...)``/quotes stay).

    The legacy ``haf-llm:<cmd>`` sugar is only allowed when it is the
    whole list: next to a comma there is no way to tell a second method
    from a comma inside the command, and silently truncating the command
    (the old parser's behavior) ran the wrong endpoint.  Mixed lists must
    use the quoted grammar form.
    """
    entries = [e for e in (s.strip() for s in split_top(text)) if e]
    if len(entries) > 1 and any(e.startswith(LEGACY_HAF_LLM)
                                for e in entries):
        culprit = next(e for e in entries if e.startswith(LEGACY_HAF_LLM))
        raise GrammarError(
            f"legacy {culprit!r} cannot be combined with commas: a comma "
            "could belong to the command or separate the next method, and "
            "the old parser silently truncated the command at it; write "
            "haf-llm(cmd=\"<cmd>\") instead (quoted commands may contain "
            "commas)")
    out = [parse_method(e) for e in entries]
    if not out:
        raise GrammarError(f"no method entries in {text!r}")
    return out


def parse_scenario(text: str) -> Dict:
    """One scenario entry → canonical ``{"family", "params", "label"}``."""
    text = text.strip()
    if not text:
        raise GrammarError("empty scenario entry")
    call = parse_call(text)
    if call is not None:
        family, params = call
        label = _pop_label(family, params)
        return {"family": family, "params": params, "label": label}
    if NAME_RE.fullmatch(text):
        return {"family": text, "params": {}, "label": text}
    raise GrammarError(
        f"cannot parse scenario entry {text!r}; expected a family name or "
        "family(k=v, ...) — e.g. flash-crowd(rho=0.95, n_ai_requests=4000)")


def parse_scenarios(text: str) -> List[Dict]:
    out = [parse_scenario(e) for e in (s.strip() for s in split_top(text))
           if e]
    if not out:
        raise GrammarError(f"no scenario entries in {text!r}")
    return out


def _format_params(params: Dict, label: str, name: str) -> List[str]:
    parts = [f"{k}={format_value(v)}" for k, v in sorted(params.items())]
    if label != name:
        parts.append(f"label={format_value(label)}")
    return parts


def format_method(method: Dict) -> str:
    """Canonical grammar string; ``parse_method`` inverts it exactly."""
    name = method["name"]
    parts = _format_params(dict(method.get("params", {})),
                           method.get("label", name), name)
    return name if not parts else f"{name}({', '.join(parts)})"


def format_scenario(scenario: Dict) -> str:
    family = scenario["family"]
    parts = _format_params(dict(scenario.get("params", {})),
                           scenario.get("label", family), family)
    return family if not parts else f"{family}({', '.join(parts)})"


SEEDS_HINT = (
    "seeds grammar: a bare count (3 -> 0,1,2), an explicit list (0,2,5), "
    "or inclusive ranges (0..4); spec files take seeds = [0, 2, 5]")


def parse_seeds(text: str) -> List[int]:
    """``"3"`` → [0,1,2]; ``"0,2,5"`` → [0,2,5]; ``"0..4"`` → [0..4].

    A bare integer is a seed COUNT (the legacy form), so ``"0"`` is an
    error — write ``"0,"``, ``"0..0"`` or a spec-file list for seed 0 only.
    """
    text = str(text).strip()
    if not text:
        raise GrammarError(f"empty seed list; {SEEDS_HINT}")
    toks = [t.strip() for t in text.split(",")]
    explicit = "," in text or ".." in text
    out: List[int] = []
    for tok in toks:
        if not tok:
            continue
        if ".." in tok:
            lo, _, hi = tok.partition("..")
            try:
                lo_i, hi_i = int(lo), int(hi)
            except ValueError:
                raise GrammarError(f"bad seed range {tok!r}; "
                                   f"{SEEDS_HINT}") from None
            if hi_i < lo_i:
                raise GrammarError(f"bad seed range {tok!r} (end < start)")
            out.extend(range(lo_i, hi_i + 1))
            continue
        try:
            val = int(tok)
        except ValueError:
            raise GrammarError(f"bad seed entry {tok!r}; "
                               f"{SEEDS_HINT}") from None
        out.append(val)
    if explicit:
        if not out:
            raise GrammarError(f"empty seed list {text!r}; {SEEDS_HINT}")
        return out
    count = out[0]
    if count <= 0:
        raise GrammarError(
            f"--seeds {count}: a bare integer is a seed COUNT "
            f"(3 -> seeds 0,1,2), so {count} selects no seeds; for seed "
            f"{count} only write '{count},' or '{count}..{count}', or "
            f"seeds = [{count}] in a spec file")
    return list(range(count))
