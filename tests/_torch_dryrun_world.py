"""Runs ``repro_torch.launch.dryrun``'s CLI in a process of its own (the
fake world of 256 or 512 ranks is this process's only process group), once
for each group of arguments, appending the rows to one file:

    python tests/_torch_dryrun_world.py ROWS.json ARGS... [-- ARGS...]

prints each run's exit code, one a line.  Imports nothing of JAX."""
import sys

from repro_torch.launch import dryrun


def main(argv) -> int:
    out, groups, cur = argv[0], [], []
    for a in argv[1:]:
        if a == "--":
            groups.append(cur)
            cur = []
        else:
            cur.append(a)
    groups.append(cur)
    for group in groups:
        print(f"rc {dryrun.main(group + ['--out', out])}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
