"""Network layers over the engine's message fabric (the counterpart of
`madsim_tpu.net`):

  rpc      — typed request/response with call-id matching and retries
  service  — @rpc method dispatch with stable hashed tags

The reliable stream layer (`stream`, `streaming`), the connection
lifecycle (`conn`) and `codegen` wait for their slice (ROADMAP P9).
"""
