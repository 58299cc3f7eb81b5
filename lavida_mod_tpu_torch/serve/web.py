"""Browser chat UI, the port's copy of lavida_mod_tpu/serve/web.py: the
gradio web-server analogue (reference llava/serve/gradio_web_server.py:
1-442 and gradio_multi_image.py:1-448) without the gradio dependency.  The
model worker serves this single-page app on GET: several images per turn,
multi-turn chat history (client-side state, one <image> marker per
attached image, the reference's multi-image prompt construction) and
sampler knobs, posting to the worker's own /worker_generate."""

from __future__ import annotations

PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>LaViDa</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:820px;margin:2rem auto;padding:0 1rem}
 textarea,input,select,button{font:inherit;padding:.4rem}
 textarea{width:100%%}
 #chat{background:#f6f6f6;border-radius:8px;padding:1rem;min-height:6rem}
 .turn{margin:.4rem 0}.turn b{color:#345}
 .row{display:flex;gap:.75rem;align-items:center;margin:.5rem 0;flex-wrap:wrap}
 #previews img{max-height:110px;border-radius:8px;margin-right:.5rem}
</style></head><body>
<h2>LaViDa — masked-diffusion VLM</h2>
<div class="row"><input type="file" id="img" accept="image/*" multiple>
 <button id="clear">Clear chat</button></div>
<div id="previews"></div>
<div id="chat"></div>
<textarea id="prompt" rows="3">Describe the images in detail.</textarea>
<div class="row">
 <label>max new tokens <input id="mnt" type="number" value="32" style="width:5rem"></label>
 <label>steps <input id="steps" type="number" value="16" style="width:4rem"></label>
 <label>schedule <select id="sched"><option value="">none</option>
   <option>shift</option><option>cosine</option><option>linear</option></select></label>
 <label><input id="cache" type="checkbox" checked> prefix cache</label>
 <button id="go">Send</button>
</div>
<div id="lat"></div>
<script>
const b64 = f => new Promise(r => {const fr = new FileReader();
  fr.onload = () => r(fr.result.split(',')[1]); fr.readAsDataURL(f);});
let history = [];      // [{role, text}]
let pendingImages = [];  // base64 images attached to the NEXT user turn
img.onchange = async () => {
  for (const f of img.files) {
    pendingImages.push(await b64(f));
    const im = document.createElement('img');
    im.src = URL.createObjectURL(f); previews.appendChild(im);
  }
  img.value = '';
};
clear.onclick = () => {history = []; pendingImages = [];
  chat.innerHTML = ''; previews.innerHTML = ''; lat.textContent = '';};
const addTurn = (role, text) => {
  const d = document.createElement('div'); d.className = 'turn';
  d.innerHTML = '<b>' + role + ':</b> ';
  d.appendChild(document.createTextNode(text));
  chat.appendChild(d);
};
go.onclick = async () => {
  const userText = prompt.value;
  // one <image> marker per attached image, ahead of the text
  const marked = '<image>\n'.repeat(pendingImages.length) + userText;
  history.push({role: 'user', text: marked});
  addTurn('user', userText + (pendingImages.length ?
    ' [' + pendingImages.length + ' image(s)]' : ''));
  const transcript = history.map(t => t.text).join('\n');
  const gen_kwargs = {max_new_tokens: +mnt.value, step_per_block: +steps.value,
    prefix_lm: cache.checked};
  if (sched.value) {gen_kwargs.schedule = sched.value; gen_kwargs.schedule__shift = 0.33;}
  const images = pendingImages; pendingImages = []; previews.innerHTML = '';
  const r = await fetch('/worker_generate', {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({prompt: transcript, images, gen_kwargs})});
  const j = await r.json();
  const reply = j.error_code ? ('error: ' + j.error) : j.text;
  history.push({role: 'assistant', text: reply});
  addTurn('assistant', reply);
  lat.textContent = j.latency_s ? j.latency_s.toFixed(2) + ' s' : '';
  prompt.value = '';
};
</script></body></html>"""
