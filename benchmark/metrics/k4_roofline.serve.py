"""Layer: the serving decode kernel K4 (``full_group_kernel``): its
share of the roofline on the traced requests, in % (moves
``serve_segments_per_s``)."""
from benchmark.readings import k4_roofline as read  # noqa: F401
