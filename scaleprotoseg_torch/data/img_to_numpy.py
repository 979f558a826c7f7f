"""CLI: python -m scaleprotoseg_torch.data.img_to_numpy <data_type>
[--margin M]: the ``.npy`` mirror of every preprocessed PNG under
``DATA_PATH_*`` (the JAX package's arguments)."""

import argparse

from scaleprotoseg_torch.data.preprocess import img_to_numpy


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("data_type")
    p.add_argument("--margin", type=int, default=0)
    a = p.parse_args()
    img_to_numpy(a.data_type, margin=a.margin)


if __name__ == "__main__":
    main()
