"""The 95th percentile (numpy's, linear) over every request of the window
of its time to first token: its batch's submission to ``serve.run``'s
return with the first token (host clock, after the program's synchronise).
Each prompt is a request; the prompts of one batch share its time."""

import numpy as np


def read(run):
    if run.kind != "prefill":
        return None
    per_request = np.repeat(np.asarray(run.res.ttft_s) * 1e3, run.mix["batch"])
    return float(np.percentile(per_request, 95))
