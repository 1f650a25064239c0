"""RDO pyramid (models/keyframe.py analyze_rdo_pyramid, the analysis
tier): the analyze_rdo_pyramid span a frame, in ms.  The span also
counts in front_end_ms_per_frame, which reads every analyze_* span."""

from codecbench.metrics import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, "analyze_rdo_pyramid")
