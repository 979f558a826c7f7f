"""``python -m scaleprotoseg_torch.train CONFIG RUN``: the ProtoSeg
baseline trainer under the reference's ``python -m segmentation.train``
name; the same command line as ``train_wandb``, to which it delegates."""

from scaleprotoseg_torch.train_wandb import main

if __name__ == "__main__":
    main()
