"""Shared ``kind:arg`` spec parsing for every name-resolved factory.

The repo resolves pluggable components by short string specs — policies
("cnnselect", "static:<name>"), T_input estimators ("ewma:0.3"),
networks ("lte", "trace:diurnal"), control modes, change-point
detectors. Pre-refactor each factory re-implemented the same partition
/ validate / raise sequence with its own error phrasing, so a typo'd
spec surfaced differently depending on which subsystem it reached.
`parse_spec` is the one copy: every factory raises the same
registry-style `ValueError` naming the kind, the offending spec, and
every valid form.

Error contract (pinned by the factory test suites):

- unknown head   -> ``unknown <kind> <spec>; known: <names>``
- stray argument -> ``<kind> <head> takes no ':<arg>' argument; known: …``
- missing argument (heads in `required_arg_heads`)
                 -> ``<kind> <head> needs a <desc>: '<head>:<ph>'``
- non-numeric argument (heads in `numeric_arg_heads`)
                 -> ``<kind> <head> takes a numeric argument, got
                    <spec>; known: …``
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

__all__ = ["parse_spec"]


def parse_spec(spec: str, *, kind: str, heads: Iterable[str],
               known: Optional[Sequence[str]] = None,
               arg_heads: Sequence[str] = (),
               required_arg_heads: Sequence[str] = (),
               numeric_arg_heads: Sequence[str] = (),
               arg_desc: Optional[Dict[str, Tuple[str, str]]] = None
               ) -> Tuple[str, str]:
    """Parse and validate a ``head[:arg]`` spec against a registry.

    `heads` is the set of resolvable heads; `known` the human-facing
    list for error text (defaults to `heads` in iteration order, so a
    dict registry lists its declaration order). `arg_heads` may carry a
    ``:<arg>``, `required_arg_heads` must, `numeric_arg_heads` must
    parse as float. `arg_desc` maps a required head to its
    ``(description, placeholder)`` for the missing-argument message,
    e.g. ``{"static": ("model name", "name")}``. Returns ``(head,
    arg)`` with ``arg == ""`` when absent.
    """
    head, _, arg = spec.partition(":")
    head_set = set(heads)
    names = ", ".join(known if known is not None else heads)
    if head not in head_set:
        raise ValueError(f"unknown {kind} {spec!r}; known: {names}")
    if arg and head not in arg_heads:
        raise ValueError(f"{kind} {head!r} takes no ':{arg}' argument; "
                         f"known: {names}")
    if not arg and head in required_arg_heads:
        desc, ph = (arg_desc or {}).get(head, ("argument", "arg"))
        raise ValueError(f"{kind} {head!r} needs a {desc}: "
                         f"'{head}:<{ph}>'")
    if arg and head in numeric_arg_heads:
        try:
            float(arg)
        except ValueError:
            raise ValueError(
                f"{kind} {head!r} takes a numeric argument, got "
                f"{spec!r}; known: {names}") from None
    return head, arg
