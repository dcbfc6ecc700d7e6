"""Operations and bytes of the kernels and models the benchmark runs,
worked out from shapes alone, so that they hold for any implementation."""
