"""Concatenate same-named log files from two run directories
(reference python/concat_out.py) — used when a training run was restarted
and its stdout/err logs split across directories.

The port's copy of ``takzero_tpu/tools/concat_out.py``.
"""

from __future__ import annotations

import pathlib


def concat_dirs(dir_early, dir_later, out_dir) -> list[str]:
    dir_early, dir_later = pathlib.Path(dir_early), pathlib.Path(dir_later)
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    names = sorted(
        {p.name for p in dir_early.iterdir() if p.is_file()}
        | {p.name for p in dir_later.iterdir() if p.is_file()}
    )
    for name in names:
        content = ""
        for d in (dir_early, dir_later):
            try:
                content += (d / name).read_text(encoding="utf-8", errors="replace")
            except FileNotFoundError:
                pass
        (out_dir / name).write_text(content, encoding="utf-8")
    return names


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("dir_early")
    parser.add_argument("dir_later")
    parser.add_argument("out_dir")
    args = parser.parse_args(argv)
    names = concat_dirs(args.dir_early, args.dir_later, args.out_dir)
    for name in names:
        print(f"- combined {name}")


if __name__ == "__main__":
    main()
