"""Scrape evaluation logs into match_results CSVs
(reference python/get_match_results.py).

The port's copy of ``takzero_tpu/tools/match_results.py`` (host code only).

The evaluation driver logs lines like
``model_0000100.ckpt vs. model_0000200.ckpt: Evaluation { wins: 40,
losses: 20, draws: 4 }``; this extracts them from ``eval-*.err`` /
``*.log`` files into the 7-column CSV the elo fitter reads.
"""

from __future__ import annotations

import pathlib
import re

# Accepts both the reference's .ot names and our .ckpt names.
PATTERN = re.compile(
    r"([\w\-]+?)[_\-](\d+)\.(?:ot|ckpt) vs\. ([\w\-]+?)[_\-](\d+)\.(?:ot|ckpt): "
    r"Evaluation \{ wins: (\d+), losses: (\d+), draws: (\d+) \}"
)


def scrape(text: str, model_rename: str | None = None) -> list[str]:
    """CSV lines from log text; optional rename of the generic 'model'."""
    out = []
    if model_rename:
        text = text.replace("model", model_rename)
    for m in re.finditer(PATTERN, text):
        out.append(
            f"{m[1]}, {int(m[2])}, {m[3]}, {int(m[4])}, {m[5]}, {m[6]}, {m[7]}\n"
        )
    return out


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("log_dir", help="directory of eval-*.err / *.log files")
    parser.add_argument("--glob", default="eval-*.err")
    parser.add_argument("--out", default="match_results.csv")
    args = parser.parse_args(argv)

    lines: list[str] = []
    for path in sorted(pathlib.Path(args.log_dir).glob(args.glob)):
        text = path.read_text(encoding="utf-8", errors="replace")
        # Reference convention: first line of the .err file names the run
        # directory; use it to rename the generic "model" player.
        first, _, rest = text.partition("\n")
        rename = None
        if first.startswith("runs/"):
            rename = first.split("/")[1].replace("_", "-")[4:].rstrip()
            text = rest
        found = scrape(text, rename)
        print(f"{path}: {len(found)} results")
        lines.extend(found)
    with open(args.out, "w", encoding="utf-8") as f:
        f.writelines(lines)


if __name__ == "__main__":
    main()
