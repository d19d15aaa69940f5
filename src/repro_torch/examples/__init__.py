"""The reference's three examples (``examples/*.py``) on the port:
``quickstart``, ``compare_optimizers`` and ``serve_decode``, each run as
``python -m repro_torch.examples.<name>`` on the card, or on the CPU with
``--device cpu``. ``REPRO_EXAMPLE_STEPS`` caps the steps (or new tokens)
as in the reference. Each exposes ``main(device=..., params=...)``,
which returns the numbers it printed."""

import argparse
import os


def example_steps(default: int) -> int:
    """``REPRO_EXAMPLE_STEPS`` read at the call, with the example's
    default, as the reference reads it at import."""
    return int(os.environ.get("REPRO_EXAMPLE_STEPS", str(default)))


def parse_args(doc: str, argv=None, **extra):
    """The examples' command line: ``--device`` (the card unless the
    caller asks for the CPU) and each of ``extra`` (name -> argparse
    keyword arguments)."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    for name, kw in extra.items():
        ap.add_argument(name, **kw)
    return ap.parse_args(argv)
