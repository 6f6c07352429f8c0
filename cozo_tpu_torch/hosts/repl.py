"""Interactive REPL host (reference `cozo-bin/src/repl.rs`; counterpart
of `cozo_tpu/hosts/repl.py`: the same output for the same input, the
banner aside).

`%`-commands mirror the reference: %backup, %restore, %import, %save,
%run, %help; everything else evaluates as CozoScript.

    python -m cozo_tpu_torch.hosts.repl                # the Db on the card
    python -m cozo_tpu_torch.hosts.repl --device cpu   # on the host"""

from __future__ import annotations

import json
import sys
import traceback

from ..runtime.db import Db
from ..utils.errors import CozoError

HELP = """\
Enter CozoScript to run queries. Meta commands:
  %help                 show this message
  %backup <file>        backup the database to a SQLite file
  %restore <file>       restore from a backup (empty db only)
  %import <file>        import relations from a JSON file
  %save <file>          save the last result as JSON
  %run <file>           run a script file
  %exit                 leave the REPL
"""


def format_rows(res) -> str:
    d = res.to_dict()
    headers = d["headers"]
    rows = d["rows"]
    if not rows:
        return f"[{', '.join(headers)}]\n(no rows)"
    widths = [len(str(h)) for h in headers] or [0]
    str_rows = []
    for r in rows:
        sr = [json.dumps(v, ensure_ascii=False, default=str) for v in r]
        str_rows.append(sr)
        for i, cell in enumerate(sr):
            if i < len(widths):
                widths[i] = max(widths[i], len(cell))
    out = []
    if headers:
        out.append(" | ".join(str(h).ljust(w) for h, w in zip(headers, widths)))
        out.append("-+-".join("-" * w for w in widths))
    for sr in str_rows:
        out.append(" | ".join(c.ljust(w) for c, w in zip(sr, widths)))
    out.append(f"({len(rows)} row{'s' if len(rows) != 1 else ''})")
    return "\n".join(out)


def repl_main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="cozo_tpu_torch REPL")
    ap.add_argument("--engine", default="mem")
    ap.add_argument("--path", default="")
    ap.add_argument("--device", default=None,
                    help="the Db's device: the card unless 'cpu' is given")
    args = ap.parse_args(argv)
    db = Db(args.engine, args.path, device=args.device)
    print(f"cozo_tpu_torch REPL ({args.engine}, {db.device}). "
          "Type %help for help.")
    last_result = None
    buffer: list = []
    try:
        import readline  # noqa: F401
    except ImportError:
        pass
    while True:
        try:
            prompt = "... " if buffer else "=> "
            line = input(prompt)
        except (EOFError, KeyboardInterrupt):
            print()
            break
        if not buffer and line.startswith("%"):
            parts = line.split(None, 1)
            cmd = parts[0]
            arg = parts[1].strip() if len(parts) > 1 else ""
            try:
                if cmd == "%help":
                    print(HELP)
                elif cmd == "%exit":
                    break
                elif cmd == "%backup":
                    db.backup_db(arg)
                    print("backup done")
                elif cmd == "%restore":
                    db.restore_backup(arg)
                    print("restore done")
                elif cmd == "%import":
                    with open(arg, "r", encoding="utf-8") as f:
                        db.import_relations(json.load(f))
                    print("import done")
                elif cmd == "%save":
                    if last_result is None:
                        print("no result to save")
                    else:
                        with open(arg, "w", encoding="utf-8") as f:
                            json.dump(last_result.to_dict(), f)
                        print(f"saved to {arg}")
                elif cmd == "%run":
                    with open(arg, "r", encoding="utf-8") as f:
                        src = f.read()
                    last_result = db.run_script(src)
                    print(format_rows(last_result))
                else:
                    print(f"unknown meta command {cmd}; %help for help")
            except CozoError as e:
                print(f"error[{e.code}]: {e.message}")
            except OSError as e:
                print(f"io error: {e}")
            continue
        if line.endswith("\\"):
            buffer.append(line[:-1])
            continue
        buffer.append(line)
        script = "\n".join(buffer).strip()
        buffer = []
        if not script:
            continue
        try:
            last_result = db.run_script(script)
            print(format_rows(last_result))
        except CozoError as e:
            print(f"error[{e.code}]: {e.message}")
        except Exception:  # noqa: BLE001
            traceback.print_exc()


if __name__ == "__main__":
    repl_main()
