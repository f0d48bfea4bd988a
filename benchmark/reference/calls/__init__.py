"""One module per integrator, `render_call(ref, film, n) -> (film', overflow)`:
the CLI's dispatch of n frames of that integrator, on the frozen copy.
`render.render_call` finds it by the workload's integrator name."""
