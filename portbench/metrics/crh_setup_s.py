"""``crh_setup_s``: the Pedersen CRH's own share of ``setup_s``, from its
set-up counters: seconds in ``setup`` (the generators' doubling powers on the
host) and in making the grouped table and uploading it to the card
(``models/crh/pedersen.py``).  None where the program has no such
counters."""

import importlib


def read(run):
    pedersen = importlib.import_module("crypto_primitives_tpu_torch.models.crh.pedersen")
    parts = [getattr(pedersen, "setup_seconds", None), getattr(pedersen, "table_seconds", None)]
    return None if None in parts else sum(parts)
