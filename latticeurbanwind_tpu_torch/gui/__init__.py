"""LUW Studio of the port: the counterpart of the JAX package's `gui/`.

A zero-dependency local web app (stdlib http.server + one HTML page) that
edits decks against the shared schema, runs the port's pipeline commands
with console/progress forwarding (their kernels on the card) and views VTK
results.  Start with `luwstudio [case_dir]` and open the printed URL.
"""

from .server import main  # noqa: F401
