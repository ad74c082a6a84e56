#!/usr/bin/env python
"""Materialize the default FullOVSLAMConfig to JSON —
``write_configuration`` equivalent (src/refactoring/configuration/write_configuration.cpp)."""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config_output_file", required=True)
    parser.add_argument("--config_version_id", default="default")
    args = parser.parse_args(argv)

    from obvi_slam_tpu.config import (
        FullOVSLAMConfig,
        default_shape_priors,
        write_config,
    )

    config = FullOVSLAMConfig(config_version_id=args.config_version_id)
    config.shape_dimension_priors = default_shape_priors()
    write_config(config, args.config_output_file)
    print(f"wrote default config to {args.config_output_file}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
