"""Minimal Praat TextGrid parser (ctts_tpu/preprocessing/textgrid.py; in
place of the reference's `tgt` dependency).

Parses long-format TextGrid files as produced by the Montreal Forced
Aligner; exposes interval tiers with (start_time, end_time, text) objects —
the shape the alignment extractor needs (preprocessor.py:562-606).
"""

import re


class Interval:
    __slots__ = ("start_time", "end_time", "text")

    def __init__(self, start_time, end_time, text):
        self.start_time = start_time
        self.end_time = end_time
        self.text = text

    def __repr__(self):
        return f"Interval({self.start_time}, {self.end_time}, {self.text!r})"


class IntervalTier:
    def __init__(self, name, intervals):
        self.name = name
        self._objects = intervals

    def __iter__(self):
        return iter(self._objects)

    def __len__(self):
        return len(self._objects)


class TextGrid:
    def __init__(self, tiers):
        self.tiers = tiers

    def get_tier_by_name(self, name):
        for t in self.tiers:
            if t.name == name:
                return t
        raise KeyError(name)


_num_re = re.compile(r"(?:xmin|xmax|number)\s*=\s*([\d.eE+-]+)")
_text_re = re.compile(r'(?:text|mark)\s*=\s*"((?:[^"]|"")*)"')
_name_re = re.compile(r'name\s*=\s*"((?:[^"]|"")*)"')
_class_re = re.compile(r'class\s*=\s*"((?:[^"]|"")*)"')


def read_textgrid(path):
    """Parse a long-format TextGrid file → TextGrid."""
    with open(path, encoding="utf-8", errors="replace") as f:
        content = f.read()

    tiers = []
    # split on "item [n]:" blocks (skip the header "item []:")
    blocks = re.split(r"item\s*\[\d+\]\s*:", content)[1:]
    for block in blocks:
        cls = _class_re.search(block)
        name = _name_re.search(block)
        if cls is None or "IntervalTier" not in cls.group(1):
            continue
        intervals = []
        for m in re.finditer(
                r"intervals\s*\[\d+\]\s*:\s*"
                r"xmin\s*=\s*([\d.eE+-]+)\s*"
                r"xmax\s*=\s*([\d.eE+-]+)\s*"
                r'text\s*=\s*"((?:[^"]|"")*)"', block):
            s, e, text = float(m.group(1)), float(m.group(2)), m.group(3)
            intervals.append(Interval(s, e, text.replace('""', '"')))
        tiers.append(IntervalTier(name.group(1) if name else "", intervals))
    return TextGrid(tiers)
