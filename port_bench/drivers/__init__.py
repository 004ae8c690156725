"""One driver per entry point a window drives, found by the workload file's
"driver" name: `serve` (`Runner.image2image`), `train` (the loop body of
`train.run` at stage 2.2). A driver builds the program at set-up, drives the
window and a traced segment, frees the program, then rebuilds what the window
produced with the frozen reference and returns the numbers compared."""
