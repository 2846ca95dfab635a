"""``python -m navierstokessolver_tpu_torch`` runs the port's CLI (cli.main)."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
