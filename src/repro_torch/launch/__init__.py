"""Serving mesh and the serve / chaos launcher of the port (`mesh`,
`dryrun`)."""
