"""Frozen yardsticks: the H100's peaks, and the operations and bytes that a
kernel, a model step or a drain of the AsyncFedED rule needs, computed from
shapes alone. They are copies, so that a change to the program cannot move
the measure it is judged by."""
