"""Network layers over the engine's message fabric (the counterpart of
`madsim_tpu.net`):

  rpc        — typed request/response with call-id matching and retries
  service    — @rpc / @rpc_stream method dispatch with stable hashed tags
  stream     — ordered reliable delivery (sliding window, retransmission)
  conn       — connection lifecycle (listen/connect/accept/reset)
  streaming  — the four gRPC method shapes over the stream fabric
  codegen    — proto3-subset schema -> service module (host only)
"""
