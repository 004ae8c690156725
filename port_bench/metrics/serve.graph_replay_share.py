"""Share (%) of the traced segment's calls of `Runner.image2image` (the
port's spans "inversion") that replayed CUDA graphs (the port's span
"graph.replay" inside the call): 100 x replays / calls. None for a program
without graph replay."""


def read(ctx):
    try:
        from e3dge_torch.utils.trace import REPLAY
    except ImportError:
        return None
    names = [name for _, _, name in ctx.trace.host_ops]
    calls = names.count("inversion")
    return 100.0 * names.count(REPLAY) / calls if calls else None
