"""TGB training entry point of the port::

    python -m gncde_tpu_torch.run.tgb --config configs/tgb/genre_perm_equiv_gncde.yaml \
        dataset.name=tgbn-genre-synth dataset.frequency=None epochs=1 device=cuda

reads the same YAML files as ``python -m gncde_tpu.run.tgb``, with the same
dotted ``key=value`` overrides.
"""

from __future__ import annotations

import argparse

from ..train.windowed import TGBTrainer
from .common import apply_overrides, safe_load


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True, help="Path to YAML config")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = parser.parse_args(argv)

    with open(args.config) as f:
        config = safe_load(f.read())
    config = apply_overrides(config, args.overrides)
    return TGBTrainer.from_dict(config).run()


if __name__ == "__main__":
    main()
