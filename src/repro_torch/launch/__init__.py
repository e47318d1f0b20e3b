"""Launch-side tools of the port (counterpart of `repro.launch`): the H100
roofline and the kernels' work counts (`roofline`), a step's work counted
from its parts (`cost`, the counterpart of `hlo_cost`), peak-intermediate
estimates (`memory`), the GP-LVM dry run at the paper's production scale
(`gp_dryrun`), and the LM side: device meshes (`mesh`), the train /
prefill / decode step functions (`steps`), the `train` and `serve`
launchers, and the LM dry run (`dryrun`: every arch x shape x mesh cell
traced on a fake process group, a rank's ops counted by `cost`)."""
