"""``python -m cultionet_tpu_torch <command>`` runs the command line
(``scripts/cli.py``) on the card."""

from .scripts.cli import main

if __name__ == "__main__":
    main()
