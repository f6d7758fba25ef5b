"""Operations and bytes of the port's kernels and of the whole step,
computed from shapes, and the chip's published peaks."""
