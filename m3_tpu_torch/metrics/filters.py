"""Tag filters: compiled glob matchers over metric tag sets.

Reference parity: `src/metrics/filters` — filter values support `*`
wildcards, `?` single chars, `[a-z]` ranges and `{a,b}` alternation
(filters/filter.go chain/pattern matchers), combined per-tag as a
conjunction (filters/tags_filter.go); a tag filter may also require tag
absence via the negation syntax (`tag:!value`-style handled at the rule
layer in the reference; here an explicit `negate` flag).

The port's copy of ``m3_tpu/metrics/filters.py``.
"""

from __future__ import annotations

import functools
import re
from dataclasses import dataclass


@functools.lru_cache(maxsize=4096)
def glob_to_regex(pattern: bytes) -> re.Pattern:
    """Compile an M3-style glob to an anchored regex."""
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i : i + 1]
        if c == b"*":
            out.append(b".*")
        elif c == b"?":
            out.append(b".")
        elif c == b"[":
            j = pattern.find(b"]", i + 1)
            if j < 0:
                out.append(re.escape(c))
            else:
                out.append(pattern[i : j + 1])
                i = j
        elif c == b"{":
            j = pattern.find(b"}", i + 1)
            if j < 0:
                out.append(re.escape(c))
            else:
                alts = pattern[i + 1 : j].split(b",")
                out.append(b"(?:" + b"|".join(re.escape(a) for a in alts) + b")")
                i = j
        else:
            out.append(re.escape(c))
        i += 1
    return re.compile(b"(?:" + b"".join(out) + b")")


@dataclass(frozen=True)
class TagFilter:
    name: bytes
    pattern: bytes
    negate: bool = False

    def matches(self, tags: dict[bytes, bytes]) -> bool:
        v = tags.get(self.name)
        if v is None:
            return self.negate
        ok = glob_to_regex(self.pattern).fullmatch(v) is not None
        return ok != self.negate


@dataclass(frozen=True)
class TagsFilter:
    """Conjunction of per-tag filters (reference tags_filter.go)."""

    filters: tuple[TagFilter, ...]

    @classmethod
    def parse(cls, spec: str) -> "TagsFilter":
        """`name:web* dc:{us,eu}-* role:!db` — space-separated
        tag:glob pairs, `!` negates (reference filter spec strings in
        rule definitions)."""
        fs = []
        for part in spec.split():
            name, _, pat = part.partition(":")
            neg = pat.startswith("!")
            if neg:
                pat = pat[1:]
            fs.append(TagFilter(name.encode(), pat.encode(), neg))
        return cls(tuple(fs))

    def matches(self, tags: dict[bytes, bytes]) -> bool:
        return all(f.matches(tags) for f in self.filters)
