"""Build the class-name -> index JSON vocabulary (JAX
``cli/create_class_map.py``): the sorted union of the comma-split labels of
the given CSVs, enumerated.

    python -m freesound_classification_tpu_torch.cli.create_class_map \\
        --train_dfs train_curated.csv train_noisy.csv \\
        --output_file classmap.json

A labels cell that pandas reads as missing (an empty one among them) counts
as the class ``"nan"``, as in the JAX CLI, which splits ``str()`` of
pandas' value.
"""

from __future__ import annotations

import argparse
import json

from freesound_classification_tpu_torch.data.dataset import (
    read_csv_columns,
)
from freesound_classification_tpu_torch.data.tables import cell_text


def create_class_map(label_columns) -> dict:
    """{class: index} over every label of every column of label cells."""
    classes = set()
    for cells in label_columns:
        for cell in cells:
            classes.update(cell_text(cell).split(","))
    return {c: i for i, c in enumerate(sorted(classes))}


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--train_dfs", required=True, type=str, nargs="+",
                        help="train CSVs with a 'labels' column")
    parser.add_argument("--output_file", required=True, type=str)
    args = parser.parse_args(argv)

    class_map = create_class_map(read_csv_columns(path, ["labels"])[0]
                                 for path in args.train_dfs)
    with open(args.output_file, "w") as f:
        json.dump(class_map, f, indent=2, sort_keys=True)
    print(f"wrote {len(class_map)} classes to {args.output_file}")


if __name__ == "__main__":
    main()
