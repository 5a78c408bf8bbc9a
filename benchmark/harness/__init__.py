r"""The benchmark's yardstick: the manifest and its files, the weights and
inputs drawn from the seed, the timed window, the reduction of a profiler
trace, and the comparison that decides `correct`."""
