"""Re-pack ``.jpds`` streams with the current coder, the twin of the
repository's ``tools/repack_jpds.py``: each stream of a directory is
unpacked and packed again (``codec_io.unpack_full`` / ``pack``), its codes,
label and instance maps and base-codec payloads checked to come back
unchanged from the new stream, and the old and new rates reported. With
``--write`` a shorter stream replaces its file and the directory's
``compress_summary.json`` totals follow; by default nothing is written.

    python -m jpdse_tpu_torch.repack RUN/bits_phase3 [more dirs] [--write]

The coder is host code, whatever the device; like every entry point of
the port, ``main`` asks for the card unless given ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional

import numpy as np

from jpdse_tpu_torch import codec_io
from jpdse_tpu_torch.platform import resolve_device


def repack_dir(d: str, write: bool) -> dict:
    """Re-pack every ``*.jpds`` under ``d``; returns ``dir``, ``files``, the
    old and new total bytes and their bpp. Raises where a stream's codes or
    side info do not survive the re-pack."""
    files = sorted(glob.glob(os.path.join(d, "*.jpds")))
    old_total = new_total = npx = 0
    for f in files:
        with open(f, "rb") as fh:
            data = fh.read()
        bs = codec_io.unpack_full(data)
        new = codec_io.pack([c[0] for c in bs.codes], bs.image_hw,
                            None if bs.side.empty() else bs.side)
        bs2 = codec_io.unpack_full(new)
        for a, b in zip(bs.codes, bs2.codes):
            if not np.array_equal(a, b):
                raise AssertionError(f"code mismatch re-packing {f}")
        for k in ("label", "instance"):
            a, b = getattr(bs.side, k), getattr(bs2.side, k)
            if (a is None) != (b is None) or (a is not None and not np.array_equal(a, b)):
                raise AssertionError(f"{k} mismatch re-packing {f}")
        if bs.side.base_payloads != bs2.side.base_payloads:
            raise AssertionError(f"base payload mismatch re-packing {f}")
        old_total += len(data)
        new_total += len(new)
        npx += bs.image_hw[0] * bs.image_hw[1]
        if write and len(new) < len(data):
            with open(f, "wb") as fh:
                fh.write(new)
    row = {
        "dir": d,
        "files": len(files),
        "old_bytes": old_total,
        "new_bytes": new_total,
        "old_bpp": old_total * 8.0 / npx if npx else 0.0,
        "new_bpp": new_total * 8.0 / npx if npx else 0.0,
    }
    summary = os.path.join(d, "compress_summary.json")
    if write and os.path.exists(summary):
        with open(summary) as fh:
            s = json.load(fh)
        if "avg_bpp" in s:
            s["avg_bpp"] = row["new_bpp"]
        if "total_bytes" in s:
            s["total_bytes"] = row["new_bytes"]
        with open(summary, "w") as fh:
            json.dump(s, fh, indent=2)
    return row


def main(argv: Optional[List[str]] = None, device="cuda") -> List[dict]:
    resolve_device(device)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args(argv)
    rows = []
    for d in args.dirs:
        r = repack_dir(d, args.write)
        print(f"{r['dir']}: {r['files']} files  {r['old_bytes']} -> {r['new_bytes']} bytes  "
              f"({r['old_bpp']:.4f} -> {r['new_bpp']:.4f} bpp, "
              f"ratio {r['new_bytes'] / max(r['old_bytes'], 1):.4f})")
        rows.append(r)
    return rows


if __name__ == "__main__":
    main()
