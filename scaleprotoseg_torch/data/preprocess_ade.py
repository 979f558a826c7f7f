"""CLI: python -m scaleprotoseg_torch.data.preprocess_ade [n_jobs]
[--source RAW] [--target OUT] (the JAX package's arguments)."""

import argparse

from scaleprotoseg_torch.data.preprocess import preprocess_ade


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("n_jobs", nargs="?", type=int, default=8)
    p.add_argument("--source", default=None)
    p.add_argument("--target", default=None)
    a = p.parse_args()
    preprocess_ade(n_jobs=a.n_jobs, source=a.source, target=a.target)


if __name__ == "__main__":
    main()
